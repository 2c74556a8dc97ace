"""SGAN training schedule: the four-phase step of the reference.

Port of radarml_tpu/train/sgan_trainer.py (the reference's loop,
sgan.py:396-543). Each step makes the reference's four Keras
`train_on_batch` updates in order — the supervised classifier on a
labeled half-batch, the unsupervised discriminator on real (positive
labels smoothed into [0.7, 1.2]) and on generated (negative smoothed into
[0, 0.3]) half-batches, then the stacked GAN on a full batch of latents
labeled real — as eager launches on the models' device.

The Keras semantics the JAX package carries, kept here:

* three independent Adam(2e-4, β1 0.5, ε 1e-7) optimizers over the same
  Parameters (c, d, gan), so one discriminator weight keeps separate
  moments under the c-, d- and GAN losses;
* the GAN phase updates the generator AND the discriminator's BatchNorm
  scale/bias only (define_gan freezes every non-BN layer,
  sgan.py:220-225): the other discriminator gradients are zeroed before
  `gan_opt` steps, so their moments stay zero and their update is 0, as
  the JAX gradient mask gives;
* fakes for the d-phase come from the generator in inference mode
  (running BN stats, no update); the GAN phase runs it in training mode;
* dropout is live in every phase, and the discriminator's BatchNorms use
  batch statistics in every phase;
* `class_weight` on the real-d update is the constant scale
  w_classes[1] (sgan.py:528-530).

The step takes its random draws as tensors (`SGANDraws`): the latents,
the smoothed labels and the dropout masks. `train_sgan` draws them from a
torch.Generator seeded from (seed, step), so a resumed run replays the
uninterrupted one; batch indices come from `np.random.default_rng(seed)`
as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from radarml_tpu_torch.core.arena import RADAR_MAX
from radarml_tpu_torch.core.device import resolve_device
from radarml_tpu_torch.models.cnn import dropout_masks
from radarml_tpu_torch.models.sgan import (
    LATENT_DIM,
    Discriminator,
    FlaxBatchNorm,
    Generator,
    custom_activation,
    global_batch_stats,
    n_upsamples_for,
    sgan_init_trees,
    sgan_params_from_numpy,
    sgan_params_to_numpy,
)
from radarml_tpu_torch.ops.resample import bicubic_pair
from radarml_tpu_torch.parallel.mesh import local_mesh
from radarml_tpu_torch.train.trainer import all_reduce_grads, seeded_generator

logger = logging.getLogger(__name__)

__all__ = [
    "SGANConfig",
    "SGANState",
    "SGANDraws",
    "sgan_init",
    "make_state",
    "draw_step",
    "make_sgan_step",
    "train_sgan",
    "select_supervised_samples",
    "generate_fake_dataset",
    "pooled_disc_stats",
    "pooled_gen_stats",
    "recalibrate_bn_stats",
    "recalibrate_gen_stats",
    "classifier_eval",
    "sgan_state_tree",
    "load_sgan_state_tree",
]

# Native (cols, rows) projection sizes generated fakes are resized back
# to (reference sgan.py:43-45).
XZ_SIZE = (176, 22)
YZ_SIZE = (176, 31)
XY_SIZE = (31, 22)


@dataclasses.dataclass(frozen=True)
class SGANConfig:
    n_classes: int = 3
    latent_dim: int = LATENT_DIM
    n_epochs: int = 15
    n_batch: int = 32
    learning_rate: float = 2e-4
    beta1: float = 0.5
    n_sup_samples: int = 150
    seed: int = 1234


class SGANState(NamedTuple):
    """Both networks (parameters and BatchNorm statistics) and the three
    optimizers; the step updates all of them in place."""

    gen: Generator
    disc: Discriminator
    c_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    gan_opt: torch.optim.Adam


class SGANDraws(NamedTuple):
    """One step's random draws. masks: the discriminator's dropout
    multipliers of the c, d-real, d-fake and GAN phases (each a pair, or
    None with dropout off)."""

    y_real: torch.Tensor  # (half, 1) in [0.7, 1.2)
    z_fake: torch.Tensor  # (half, latent)
    y_fake: torch.Tensor  # (half, 1) in [0, 0.3)
    z_gan: torch.Tensor  # (n_batch, latent)
    y_gan: torch.Tensor  # (n_batch, 1) in [0.7, 1.2)
    masks: Tuple


def _adam(params, cfg: SGANConfig, dev: torch.device) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(cfg.beta1, 0.999),
                            eps=1e-7, fused=dev.type == "cuda")


def _bn_params(disc: Discriminator) -> List[str]:
    """Names of the discriminator's BatchNorm parameters (the only ones
    the GAN phase may move)."""
    return [n for n, _ in disc.named_parameters() if "BatchNorm" in n]


def sgan_init(
    cfg: SGANConfig, rescale: Tuple[int, int] = (128, 128),
    device: torch.device | str | None = None,
) -> Tuple[Generator, Discriminator, SGANState]:
    """Fresh networks on `device` (default: the card), weights from
    sgan_init_trees(seed=cfg.seed), and the three optimizers."""
    dev = resolve_device(device)
    gen = Generator(n_upsamples_for(rescale), cfg.latent_dim)
    disc = Discriminator(cfg.n_classes, rescale)
    (gp, gs), (dp, ds) = sgan_init_trees(cfg.n_classes, rescale, cfg.seed, cfg.latent_dim)
    gen.load_state_dict(sgan_params_from_numpy(gp, gs))
    disc.load_state_dict(sgan_params_from_numpy(dp, ds))
    return gen, disc, make_state(gen.to(dev), disc.to(dev), cfg)


def make_state(gen: Generator, disc: Discriminator, cfg: SGANConfig) -> SGANState:
    """SGANState over existing networks, with fresh optimizers."""
    dev = next(disc.parameters()).device
    return SGANState(gen, disc, _adam(disc.parameters(), cfg, dev),
                     _adam(disc.parameters(), cfg, dev),
                     _adam(list(gen.parameters()) + list(disc.parameters()), cfg, dev))


def draw_step(cfg: SGANConfig, half: int, disc: Discriminator,
              generator: torch.Generator) -> SGANDraws:
    """One step's draws from `generator`, on its device."""
    def u(n):
        return torch.rand((n, 1), generator=generator, device=generator.device)

    def z(n):
        return torch.randn((n, cfg.latent_dim), generator=generator,
                           device=generator.device)

    def m(n):
        return dropout_masks(2, (n, disc.dense_width), disc.dropout_rate, generator)

    return SGANDraws(y_real=0.7 + u(half) * 0.5, z_fake=z(half), y_fake=u(half) * 0.3,
                     z_gan=z(cfg.n_batch), y_gan=0.7 + u(cfg.n_batch) * 0.5,
                     masks=(m(half), m(half), m(half), m(cfg.n_batch)))


def _shard_draws(draws: SGANDraws, mesh) -> SGANDraws:
    """This rank's rows of one step's global draws."""
    def rows(t):
        return t[mesh.rows(len(t))]

    masks = tuple(None if m is None else [rows(a) for a in m] for m in draws.masks)
    return SGANDraws(*(rows(t) for t in draws[:-1]), masks=masks)


def make_sgan_step(gen: Generator, disc: Discriminator, cfg: SGANConfig,
                   real_weight: float = 1.0, mesh=None) -> Callable:
    """The four-phase train step.

    Signature: step(state, sup_views, sup_labels, real_views, draws)
    → (state, losses dict of 0-d tensors). Views are (B, H, W, 3) stacks
    on the networks' device; `state` is updated in place.

    With a mesh of several data ranks, the inputs are the global batch on
    every rank and the state is replicated: each rank takes its rows of
    the views, the labels and the draws (latents, label noise, dropout
    masks), the means of the losses divide by the global batch, the
    BatchNorms take global statistics (`models.sgan.global_batch_stats`)
    and the gradients are summed over the ranks before each update, so
    the step computes the single-device step's function. The losses
    returned are the global batch's.
    """
    mesh = local_mesh(mesh, next(disc.parameters()).device)
    d = mesh.data_size
    bn = set(_bn_params(disc))
    frozen = [p for n, p in disc.named_parameters() if n not in bn]
    d_params = list(disc.parameters())
    gan_params = list(gen.parameters()) + d_params

    def gmean(t):
        """This rank's share of the global batch's mean of `t`."""
        return torch.mean(t) / d

    def bce(p, y):
        """Keras binary_crossentropy on probabilities, clipped like Keras."""
        eps = 1e-7
        p = torch.clamp(p, eps, 1.0 - eps)
        return -gmean(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))

    def step(state: SGANState, sup_views, sup_labels, real_views, draws: SGANDraws):
        sup_views = sup_views[mesh.rows(len(sup_views))]
        sup_labels = sup_labels[mesh.rows(len(sup_labels))]
        real_views = real_views[mesh.rows(len(real_views))]
        draws = _shard_draws(draws, mesh)
        c_masks, r_masks, f_masks, g_masks = draws.masks
        with global_batch_stats(mesh, gen, disc):
            # ---- phase 1: supervised classifier on the labeled half-batch ----
            state.c_opt.zero_grad(set_to_none=True)
            logits = disc(sup_views, True, c_masks)
            c_loss = -gmean(torch.log_softmax(logits, -1).gather(1, sup_labels[:, None]))
            c_loss.backward()
            all_reduce_grads(mesh, d_params)
            state.c_opt.step()
            c_acc = gmean((logits.detach().argmax(-1) == sup_labels).to(torch.float32))

            # ---- phase 2: unsupervised d on real, positive smoothing ----
            state.d_opt.zero_grad(set_to_none=True)
            p = custom_activation(disc(real_views, True, r_masks))
            dr_loss = real_weight * bce(p, draws.y_real)
            dr_loss.backward()
            all_reduce_grads(mesh, d_params)
            state.d_opt.step()

            # ---- phase 3: d on fakes (generator in inference mode) ----
            with torch.no_grad():
                fake = torch.cat(gen(draws.z_fake, train=False), dim=-1)
            state.d_opt.zero_grad(set_to_none=True)
            df_loss = bce(custom_activation(disc(fake, True, f_masks)), draws.y_fake)
            df_loss.backward()
            all_reduce_grads(mesh, d_params)
            state.d_opt.step()

            # ---- phase 4: generator via the stacked GAN ----
            state.gan_opt.zero_grad(set_to_none=True)
            fake3 = torch.cat(gen(draws.z_gan, train=True), dim=-1)
            g_loss = bce(custom_activation(disc(fake3, True, g_masks)), draws.y_gan)
            g_loss.backward()
            all_reduce_grads(mesh, gan_params)
            # Freeze everything in the discriminator except BatchNorm.
            for q in frozen:
                q.grad.zero_()
            state.gan_opt.step()

        out = mesh.all_reduce_(torch.stack([c_loss.detach(), c_acc, dr_loss.detach(),
                                            df_loss.detach(), g_loss.detach()]))
        return state, dict(zip(("c_loss", "c_acc", "d_real", "d_fake", "gan"), out))

    return step


def select_supervised_samples(
    X, y: np.ndarray, sup_mask: Optional[np.ndarray], n_samples: int,
    n_classes: int, rng: np.random.Generator,
):
    """Balanced labeled subset (sgan.py:406-422); with-replacement draw.

    The indices come from the label vector on the host, so a tensor X is
    gathered on its device.
    """
    if sup_mask is None:
        sup_mask = np.ones(len(y), bool)
    y = np.asarray(y)
    sup_mask = np.asarray(sup_mask, bool)
    n_per = n_samples // n_classes
    sel, ys = [], []
    for c in range(n_classes):
        pool_idx = np.nonzero((y == c) & sup_mask)[0]
        if len(pool_idx) == 0:
            raise ValueError(f"Not enough class {c} sup samples")
        ix = rng.integers(0, len(pool_idx), n_per)
        sel.append(pool_idx[ix])
        ys.append(np.full(n_per, c))
    sel = np.concatenate(sel)
    if isinstance(X, torch.Tensor):
        X_sup = X.index_select(0, torch.as_tensor(sel, device=X.device))
    else:
        X_sup = np.asarray(X)[sel]
    return X_sup, np.concatenate(ys)


@torch.no_grad()
def generate_fake_dataset(gen: Generator, n_samples: int, generator: torch.Generator,
                          latent_dim: int = LATENT_DIM) -> Dict:
    """Reference summarize_performance data product (sgan.py:457-501):
    generate fakes in inference mode, rescale [-1,1]→[0,255],
    bicubic-resize back to the native projection sizes, package as a
    reference-format dataset."""
    z = torch.randn((n_samples, latent_dim), generator=generator, device=generator.device)
    outs = []
    for stack, (cols, rows) in zip(gen(z, train=False), (XZ_SIZE, YZ_SIZE, XY_SIZE)):
        planes = RADAR_MAX * (stack[..., 0] + 1.0) / 2.0
        r, c = (torch.as_tensor(m, dtype=torch.float32, device=planes.device)
                for m in bicubic_pair(tuple(planes.shape[1:]), (rows, cols)))
        outs.append(torch.einsum("oh,bhw,pw->bop", r, planes, c).cpu().numpy())
    XZ, YZ, XY = outs
    samples = [(XZ[i], YZ[i], XY[i]) for i in range(n_samples)]
    return {"samples": samples, "labels": ["generated_data"] * n_samples}


def _bn_layers(module) -> List[Tuple[str, FlaxBatchNorm]]:
    return [(n, m) for n, m in module.named_modules() if isinstance(m, FlaxBatchNorm)]


@torch.no_grad()
def _pooled_stats(module, run, inputs) -> Dict[str, torch.Tensor]:
    """Precise-BN: exact population moments of the union of the equal-size
    batches `inputs` (mean of means; E[var + mean²] − pooled mean²), each
    batch normalised by its own statistics. Returns the running-stat
    entries of the module's state dict; the module's own are untouched."""
    layers = _bn_layers(module)
    saved = [(bn.momentum, bn.running_mean.clone(), bn.running_var.clone())
             for _, bn in layers]
    per = {n: ([], []) for n, _ in layers}
    try:
        for _, bn in layers:
            bn.momentum = 0.0  # the running stats become the batch's own
        for x in inputs:
            run(x)
            for n, bn in layers:
                per[n][0].append(bn.running_mean.clone())
                per[n][1].append(bn.running_var.clone())
    finally:
        for (_, bn), (m, rm, rv) in zip(layers, saved):
            bn.momentum = m
            bn.running_mean.copy_(rm)
            bn.running_var.copy_(rv)
    out = {}
    for n, (means, vars_) in per.items():
        means, vars_ = torch.stack(means), torch.stack(vars_)
        m = means.mean(0)
        out[f"{n}.running_mean"] = m
        out[f"{n}.running_var"] = torch.clamp((vars_ + means**2).mean(0) - m**2, min=0.0)
    return out


def pooled_disc_stats(disc: Discriminator, batches) -> Dict[str, torch.Tensor]:
    """Pooled BatchNorm statistics of the discriminator over `batches`
    ((P, B, H, W, 3)), dropout off; the port of the JAX `_recal_fn`."""
    return _pooled_stats(disc, lambda xb: disc(xb, True, None), batches)


def pooled_gen_stats(gen: Generator, zs) -> Dict[str, torch.Tensor]:
    """Pooled BatchNorm statistics of the generator over latent batches
    `zs` ((P, B, latent)); the port of the JAX `_gen_recal_fn`."""
    return _pooled_stats(gen, lambda z: gen(z, train=True), zs)


def recalibrate_bn_stats(disc: Discriminator, state: SGANState, X, batch: int = 64,
                         n_passes: int = 16, seed: int = 0) -> SGANState:
    """Precise-BN: replace the discriminator's running statistics with
    population statistics measured under eval conditions (dropout off,
    each batch normalized by its own stats), over n_passes batches drawn
    by `np.random.default_rng(seed)` as the JAX package draws them.

    Keras-parity momentum-0.99 EMAs need ~600 steps to forget their
    (0, 1) start, far longer than a short schedule on a small dataset, so
    inference-mode eval would read near chance while train-mode accuracy
    is high (the reference hides this with 3465 steps, sgan.py:504-543).
    """
    dev = next(disc.parameters()).device
    X = torch.as_tensor(X, dtype=torch.float32).to(dev)
    idx = np.random.default_rng(seed).integers(0, X.shape[0], size=(n_passes * batch,))
    batches = X.index_select(0, torch.as_tensor(idx, device=dev)).view(
        (n_passes, batch) + tuple(X.shape[1:]))
    disc.load_state_dict(pooled_disc_stats(disc, batches), strict=False)
    return state


def recalibrate_gen_stats(gen: Generator, state: SGANState, generator: torch.Generator,
                          latent_dim: int = LATENT_DIM, batch: int = 32,
                          n_passes: int = 16) -> SGANState:
    """Precise-BN for the generator: population stats over fresh latent
    draws from `generator`, so inference-mode generation reflects the
    trained generator on short schedules."""
    zs = torch.randn((n_passes, batch, latent_dim), generator=generator,
                     device=generator.device)
    gen.load_state_dict(pooled_gen_stats(gen, zs), strict=False)
    return state


@torch.no_grad()
def classifier_eval(disc: Discriminator, state: SGANState, X, y: np.ndarray,
                    batch: int = 64) -> float:
    """Supervised-head accuracy in inference mode."""
    dev = next(disc.parameters()).device
    X = torch.as_tensor(X, dtype=torch.float32).to(dev)
    y = torch.as_tensor(np.asarray(y), dtype=torch.int64, device=dev)
    correct = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(0, len(y), batch):
        pred = disc(X[s:s + batch], False).argmax(-1)
        correct += (pred == y[s:s + batch]).sum()
    return int(correct) / max(len(y), 1)


def sgan_state_tree(state: SGANState) -> Dict:
    """The state as state dicts (a checkpoint's tree)."""
    return {k: getattr(state, k).state_dict() for k in SGANState._fields}


def load_sgan_state_tree(state: SGANState, tree: Dict) -> SGANState:
    """Load a sgan_state_tree into `state` in place."""
    dev = next(state.disc.parameters()).device
    for k in SGANState._fields:
        obj = getattr(state, k)
        if isinstance(obj, torch.nn.Module):
            obj.load_state_dict({n: t.to(dev) for n, t in tree[k].items()})
        else:
            obj.load_state_dict(tree[k])
    return state


def _summarize(i, gen, disc, state, val_set, cfg, results_dir, generator, on_summary):
    acc = classifier_eval(disc, state, val_set[0], val_set[1])
    logger.info("Classifier accuracy at step %d: %.2f%%", i + 1, acc * 100)
    if results_dir:
        os.makedirs(results_dir, exist_ok=True)
        data = generate_fake_dataset(gen, 100, generator, cfg.latent_dim)
        path = os.path.join(results_dir, f"generated_data_{i + 1:04d}.pickle")
        with open(path, "wb") as fp:
            pickle.dump(data, fp)
        # Both networks in the JAX package's flax layout; the optimizer
        # states live in the checkpoint store.
        (gp, gs), (dp, ds) = sgan_params_to_numpy(gen), sgan_params_to_numpy(disc)
        ck = os.path.join(results_dir, f"sgan_state_{i + 1:04d}.pickle")
        with open(ck, "wb") as fp:
            pickle.dump({"g_params": gp, "g_stats": gs, "d_params": dp, "d_stats": ds}, fp)
        logger.info("Saved: %s and %s", path, ck)
    if on_summary is not None:
        on_summary(i, acc, state)


def train_sgan(
    gen: Generator,
    disc: Discriminator,
    state: SGANState,
    train_set,
    val_set,
    cfg: SGANConfig = SGANConfig(),
    w_classes: Optional[Dict[int, float]] = None,
    results_dir: Optional[str] = None,
    summarize_every: Optional[int] = None,
    on_summary: Optional[Callable] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
) -> SGANState:
    """Run the reference schedule: bat_per_epo × n_epochs steps, with
    precise-BN recalibration, evaluation and artifacts every
    `summarize_every` steps (default: an epoch).

    With `checkpoint_dir`, the full state (both nets and the three
    optimizers) is checkpointed at every summary; `resume` restores the
    latest checkpoint and continues mid-run.
    """
    X, y, sup = train_set
    dev = next(disc.parameters()).device
    rng = np.random.default_rng(cfg.seed)
    X_sup, y_sup = select_supervised_samples(X, y, sup, cfg.n_sup_samples,
                                             cfg.n_classes, rng)
    bat_per_epo = max(int(X.shape[0] / cfg.n_batch), 1)
    n_steps = bat_per_epo * cfg.n_epochs
    half = cfg.n_batch // 2
    real_weight = float(w_classes.get(1, 1.0)) if w_classes else 1.0
    step_fn = make_sgan_step(gen, disc, cfg, real_weight=real_weight)
    every = summarize_every or bat_per_epo

    store = None
    start_step = 0
    if checkpoint_dir:
        from radarml_tpu_torch.train.checkpoint import CheckpointStore

        store = CheckpointStore(checkpoint_dir)
        if resume and store.latest_step() is not None:
            start_step, tree, _ = store.restore()
            load_sgan_state_tree(state, tree)
            for _ in range(start_step):  # the host index stream to its place
                rng.integers(0, len(y_sup), half)
                rng.integers(0, X.shape[0], half)
            logger.info("resumed from checkpoint step %d", start_step)

    logger.info("n_epochs=%d, n_batch=%d, 1/2=%d, b/e=%d, steps=%d",
                cfg.n_epochs, cfg.n_batch, half, bat_per_epo, n_steps)
    X_sup_d = torch.as_tensor(X_sup, dtype=torch.float32).to(dev)
    y_sup_d = torch.as_tensor(y_sup, dtype=torch.int64, device=dev)
    X_d = torch.as_tensor(X, dtype=torch.float32).to(dev)
    debug = logger.isEnabledFor(logging.DEBUG)
    t0 = time.perf_counter()
    for i in range(start_step, n_steps):
        six = torch.as_tensor(rng.integers(0, len(y_sup), half), device=dev)
        rix = torch.as_tensor(rng.integers(0, X.shape[0], half), device=dev)
        draws = draw_step(cfg, half, disc, seeded_generator(dev, cfg.seed, i))
        state, losses = step_fn(state, X_sup_d.index_select(0, six),
                                y_sup_d.index_select(0, six),
                                X_d.index_select(0, rix), draws)
        if debug:
            logger.debug(
                "Training results at step %d: c[%.3f,%.0f], d_r[%.3f], d_f[%.3f], g[%.3f]",
                i + 1, float(losses["c_loss"]), float(losses["c_acc"]) * 100,
                float(losses["d_real"]), float(losses["d_fake"]), float(losses["gan"]))
        if (i + 1) % every == 0:
            # Eval, checkpoint and artifacts see precise-BN population
            # stats, not the slow momentum-0.99 EMA warm-up.
            recalibrate_bn_stats(disc, state, X_d, seed=i)
            recalibrate_gen_stats(gen, state, seeded_generator(dev, cfg.seed, i, 1),
                                  cfg.latent_dim)
            _summarize(i, gen, disc, state, val_set, cfg, results_dir,
                       seeded_generator(dev, cfg.seed, i, 2), on_summary)
            if store is not None:
                store.save(i + 1, sgan_state_tree(state))
    if n_steps % every:
        recalibrate_bn_stats(disc, state, X_d, seed=n_steps)
        recalibrate_gen_stats(gen, state, seeded_generator(dev, cfg.seed, n_steps, 3),
                              cfg.latent_dim)
    done = n_steps - start_step
    wall = time.perf_counter() - t0
    logger.info("%d steps in %.1fs (%.2f steps/s)", done, wall, done / max(wall, 1e-9))
    return state
