"""Readings that the comparison's limits are set from, at a cell's own size.

    python3 portbench/calibrate.py --workload <name> --seeds 12 --control-seeds 3 \
        --fault-seeds 3 --seconds 2

For each seed, in one process (the model is made once): the pool drawn
from the seed, a short window of the cell's own load, and the judge's
numbers of the kept answers against the reference, for the program, for
the configuration's control in its place (the next lower precision) and
for the program with one answer altered a step where it is produced.
Prints one JSON line a run, with the numbers, the gaps' quantiles and
the share of targets the reference leaves UNKNOWN or near a tie. The
lower reading of a number is the largest the program gives, the upper
the smallest the control or the fault gives; limits/<workload>.json
holds a limit between them. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEED0 = 2_147_483_000


def altered(program, n_classes: int):
    """The program with the first slot's answer of each step altered where
    it is produced: its class moved on by one and its probabilities rolled."""

    def call(cubes, xyz, valid):
        pred, best, proba = program(cubes, xyz, valid)
        pred, proba = pred.clone(), proba.clone()
        pred[0, 0] = (pred[0, 0] + 1) % n_classes
        proba[0, 0] = proba[0, 0].roll(1)
        return pred, best, proba

    return call


def stats(cell, batches, window, refs) -> dict:
    """Quantiles of the valid targets' gaps, and the shares of targets the
    reference leaves UNKNOWN or within the tie margin of a tie or of the
    threshold."""
    import numpy as np

    gaps, unknown, near, n = [], 0, 0, 0
    g, mp = cell.tie_margin, float(cell.config["min_proba"])
    for b, pred, proba in window.kept:
        (rp, rpr), v = refs[b], batches[b].valid.cpu().numpy()
        gaps.append(np.abs(proba - rpr).max(-1)[v])
        top = np.sort(rpr[v], -1)
        unknown += int((rp[v] == -1).sum())
        near += int(((top[:, -1] - top[:, -2] <= 2 * g) | (np.abs(top[:, -1] - mp) <= g)).sum())
        n += int(v.sum())
    q = np.quantile(np.concatenate(gaps), [0.5, 0.99, 0.999, 1.0])
    return {"gap_p50": q[0], "gap_p99": q[1], "gap_p999": q[2], "gap_max": q[3],
            "unknown_share": unknown / n, "near_share": near / n, "judged_targets": n}


def main(argv=None) -> int:
    import numpy as np
    import torch

    from portbench.run import cache_dirs, judge_window, prepare
    from portbench.spec import load_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first-seed", type=int, default=SEED0)
    args = p.parse_args(argv)
    cell = load_cell(ROOT, args.workload)
    cache_dirs(ROOT)
    device = torch.device("cuda:0")
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    model, program = prepare(cell, device)
    control = cell.family.control(cell, model, device)
    fault = altered(program, len(cell.config["classes"]))
    runs = ([("program", program)] * args.seeds + [("control", control)] * args.control_seeds
            + [("fault", fault)] * args.fault_seeds)
    for i, (role, fn) in enumerate(runs):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        batches = cell.kind.pool(cell.traffic, seed, device)
        loop = cell.kind.Loop(fn, batches, cell.traffic, device)
        loop.warm(1)
        window = loop.run(args.seconds, np.random.default_rng([seed, 1]))
        numbers, failed, refs = judge_window(cell, model, batches, window)
        line = {"workload": cell.name, "role": role, "seed": seed, "numbers": numbers,
                "failed": failed, "steps": len(window.steps),
                **stats(cell, batches, window, refs), "s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        del batches, loop, window
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
