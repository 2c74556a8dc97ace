"""Seed table of the dnn app's recipe on the CPU: the JAX package's
trainer and the port's, from the same initial parameters.

The data is the dnn app's: make_dataset(2280, seed=1234, hardness=1.0),
each package's preprocess_multiview at 80 x 80 with the app's 0.8 split.
A seed k is the JAX initial parameters init_cnn(PRNGKey(k)) (carried into
the port by cnn_params_from_numpy) and TrainConfig.seed = k. Each run
trains 8 epochs at the app's settings (batch 64, lr 2e-4, beta1 0.5,
dropout 0.5 on both dense layers). A run "learns" when its best val
loss falls below 1.0 (ln 3 = 1.0986 is chance for 3 balanced classes).

Run from the root of a checkout (the JAX package on the CPU):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/dnn_seed_table.py --seeds 0 1 2 3 4

Prints one JSON line a run, then a summary line; `--package jax|torch`
runs one package only (two processes can then share the work).
"""

import argparse
import json
import time

import numpy as np

EPOCHS, N_SAMPLES, DATA_SEED, HARDNESS, RESCALE = 8, 2280, 1234, 1.0, (80, 80)
LEARNS = 1.0


def jax_runs(seeds):
    import jax

    from radarml_tpu.data.preprocess import preprocess_multiview
    from radarml_tpu.data.synthetic import make_dataset
    from radarml_tpu.models.cnn import init_cnn
    from radarml_tpu.train.trainer import TrainConfig, train_cnn

    samples, labels = make_dataset(N_SAMPLES, seed=DATA_SEED, hardness=HARDNESS)
    pre = preprocess_multiview(samples, labels, rescale=RESCALE, train_split=0.8)
    for k in seeds:
        model, params = init_cnn(jax.random.PRNGKey(k), pre["n_classes"], RESCALE)
        t0 = time.perf_counter()
        _, hist = train_cnn(model, params, pre["X_train"], pre["y_train"], pre["X_val"],
                            pre["y_val"], w_classes=pre["w_classes"],
                            config=TrainConfig(epochs=EPOCHS, seed=k))
        yield k, hist, time.perf_counter() - t0


def torch_runs(seeds):
    import jax

    from radarml_tpu.models.cnn import init_cnn as jax_init_cnn
    from radarml_tpu_torch.data.preprocess import preprocess_multiview
    from radarml_tpu_torch.data.synthetic import make_dataset
    from radarml_tpu_torch.models.cnn import cnn_params_from_numpy, init_cnn
    from radarml_tpu_torch.train.trainer import TrainConfig, train_cnn

    samples, labels = make_dataset(N_SAMPLES, seed=DATA_SEED, hardness=HARDNESS)
    pre = preprocess_multiview(samples, labels, rescale=RESCALE, train_split=0.8,
                               device="cpu")
    for k in seeds:
        _, params = jax_init_cnn(jax.random.PRNGKey(k), pre["n_classes"], RESCALE)
        model = init_cnn(pre["n_classes"], RESCALE, device="cpu")
        model.load_state_dict(cnn_params_from_numpy(jax.tree.map(np.asarray, params)))
        t0 = time.perf_counter()
        _, hist = train_cnn(model, pre["X_train"], pre["y_train"], pre["X_val"], pre["y_val"],
                            w_classes=pre["w_classes"],
                            config=TrainConfig(epochs=EPOCHS, seed=k))
        yield k, hist, time.perf_counter() - t0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    p.add_argument("--package", choices=("jax", "torch", "both"), default="both")
    args = p.parse_args(argv)
    learned = {}
    runs = {"jax": jax_runs, "torch": torch_runs}
    for pkg in (("jax", "torch") if args.package == "both" else (args.package,)):
        for k, hist, s in runs[pkg](args.seeds):
            best = float(min(hist["val_loss"]))
            learned.setdefault(pkg, []).append(best < LEARNS)
            print(json.dumps({"package": pkg, "seed": k, "best_val_loss": best,
                              "best_val_accuracy": float(max(hist["val_accuracy"])),
                              "val_loss": [float(v) for v in hist["val_loss"]],
                              "loss": [float(v) for v in hist["loss"]], "s": s}), flush=True)
    print(json.dumps({"learned": {pkg: f"{sum(v)} of {len(v)}" for pkg, v in learned.items()},
                      "below": LEARNS, "epochs": EPOCHS}), flush=True)


if __name__ == "__main__":
    main()
