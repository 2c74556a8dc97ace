"""Time of the SGD walk on the card, across source trees.

The train app's SGD grid (the reference grid, 5 folds) walks each
penalty group's folds and candidates per sample, one CUDA graph an
epoch (models/linear._Walk). This script runs the train app's SGD family
on make_dataset(2280, seed=1234, hardness=1.0), as chip_smoke.py's
phase 12 does, and reports:

* the app's seconds, and each group's epochs and seconds (WALK_LOG);
* the largest CV group's graph epoch and the refit's, in ms (CUDA
  events over `--epochs` replays after a warm one), on the app's own
  cached walks.

Each `--tree` runs in a process of its own with that tree's package on
the path, in the order given (give them as A B B A to compare two trees
in one call); the data is made once, in a temporary directory.

Usage (one CUDA card; run from the root of a checkout):

    python radarml_tpu_torch/utils/walk_bench.py --tree OLD --tree . --tree . --tree OLD

Prints one JSON line for each process, then one summary line per tree,
and writes them all to `--out` (default chiprun_out/walk_bench.json).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

N_SAMPLES, SEED, HARDNESS = 2280, 1234, 1.0


def _epoch_ms(walk, n_epochs: int) -> float:
    import numpy as np
    import torch

    perms = np.random.default_rng(0)
    walk.epoch(perms.permutation(walk.shape[2]))
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n_epochs):
        walk.epoch(perms.permutation(walk.shape[2]))
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n_epochs


def run_one(d: str, n_epochs: int) -> dict:
    """The train app's SGD family on the dataset in `d`, in this process."""
    import logging

    import torch

    from radarml_tpu_torch.apps import train as train_app
    from radarml_tpu_torch.models import linear

    logging.getLogger("radarml_tpu_torch").setLevel(logging.WARNING)
    linear.WALK_LOG.clear()
    t0 = time.perf_counter()
    train_app.main(["--datasets", os.path.join(d, "data.pickle"),
                    "--svm_model", os.path.join(d, "sgd.pkl"),
                    "--label_encoder", os.path.join(d, "sgd_le.pkl"),
                    "--svm_cm", os.path.join(d, "sgd_cm.png"),
                    "--log_file", os.path.join(d, "sgd.log")])
    torch.cuda.synchronize()
    app_s = time.perf_counter() - t0
    walks = list(linear.WALK_LOG)
    big = max(walks[:-1], key=lambda w: w["shape"][1])
    out = {"package": os.path.dirname(linear.__file__), "app_s": app_s,
           "groups": [{k: w[k] for k in ("penalty", "average", "shape", "epochs", "seconds")}
                      for w in walks]}
    for name, w in (("cv_largest", big), ("refit", walks[-1])):
        walk = next(v for k, v in linear._WALKS.items()
                    if (k[0], k[1], k[3]) == (w["penalty"], w["average"], tuple(w["shape"])))
        out[f"{name}_shape"] = w["shape"]
        out[f"{name}_graph_epoch_ms"] = _epoch_ms(walk, n_epochs)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", default=[],
                   help="a source tree to run (repeatable, in order); default: this one")
    p.add_argument("--epochs", type=int, default=5, help="graph epochs timed per walk")
    p.add_argument("--out", default=os.path.join("chiprun_out", "walk_bench.json"))
    p.add_argument("--one", default=None, help=argparse.SUPPRESS)  # a child's data dir
    args = p.parse_args(argv)
    if args.one is not None:
        print(json.dumps(run_one(args.one, args.epochs)), flush=True)
        return
    trees = args.tree or [os.getcwd()]
    lines = []
    with tempfile.TemporaryDirectory() as d:
        code = ("import sys; from radarml_tpu_torch.data.synthetic import make_dataset; "
                "from radarml_tpu_torch.data.store import save_dataset; "
                f"s, l = make_dataset({N_SAMPLES}, seed={SEED}, hardness={HARDNESS}); "
                "save_dataset(sys.argv[1], s, l, append=False)")
        env = dict(os.environ, PYTHONPATH=os.path.abspath(trees[0]))
        subprocess.run([sys.executable, "-c", code, os.path.join(d, "data.pickle")],
                       env=env, check=True)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        for tree in trees:
            env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", d,
                                "--epochs", str(args.epochs)], env=env, cwd=d,
                               capture_output=True, text=True, timeout=900)
            if r.returncode:
                raise RuntimeError(f"{tree} failed:\n{r.stderr[-3000:]}")
            rec = dict(json.loads(r.stdout.strip().splitlines()[-1]), tree=tree, card=smi)
            print(json.dumps(rec), flush=True)
            lines.append(rec)
    for tree in dict.fromkeys(trees):
        runs = [r for r in lines if r["tree"] == tree]
        print(json.dumps({"tree": tree, "card": smi,
                          "app_s": [r["app_s"] for r in runs],
                          "cv_largest_graph_epoch_ms": [r["cv_largest_graph_epoch_ms"]
                                                        for r in runs],
                          "refit_graph_epoch_ms": [r["refit_graph_epoch_ms"] for r in runs]}),
              flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
