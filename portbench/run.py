"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (radarml_tpu_torch)
and BENCHMARK.json. The cell's configuration, traffic, comparison limits
and metric readers are found by name (spec.py). Set-up makes the model's
inputs and the pool of scans on the card from the seed and warms every
shape the traffic uses; the window then drives the program's predictor
for --seconds, closed loop (kinds/). With --trace 0 the result carries
the cell's end-to-end metrics; with --trace 1 a shorter traced window
gives its per-layer metrics, the device's busy and window seconds and a
breakdown. Every run then judges the delivered answers against the
plain reference (judge.py) and prints each number compared beside its
limit, last on standard error and last in the result line, which is the
last line of standard output.

Exits non-zero with no result where no CUDA card (or fewer than the cell
asks for) is present, where the program is missing, and where JAX, flax
or the JAX package were loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Top-level modules that may not be loaded in a run: JAX and the JAX
#: package, compared by whole name (the program's name begins with the
#: JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "radarml_tpu")
PROGRAM = "radarml_tpu_torch"
#: Seconds of the traced window of a --trace 1 run.
TRACE_SECONDS = 2.0


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = root / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cell: object
    batches: list
    window: object
    seconds: float
    setup_s: float
    trace: Optional[object] = None


def prepare(cell, device, role: str = "program"):
    """(model inputs, the callable under test): the program, or the
    configuration's control in its place."""
    family = cell.family
    model = family.model(cell, device)
    make = family.program if role == "program" else family.control
    return model, make(cell, model, device)


def judge_window(cell, model, batches, window):
    """(numbers, failed scans, the reference's answers by batch) of the
    kept outputs against the reference."""
    import torch

    from portbench.judge import judge

    refs, valid = {}, {}
    for b in sorted({k[0] for k in window.kept}):
        batch = batches[b]
        with torch.no_grad():
            pred, proba = cell.family.reference(cell, model, batch.cubes, batch.xyz, batch.valid)
        refs[b] = (pred.cpu().numpy(), proba.cpu().numpy())
        valid[b] = batch.valid.cpu().numpy()
    numbers, failed = judge(window.kept, refs, valid, cell.limits, cell.tie_margin,
                            float(cell.config["min_proba"]))
    return numbers, failed, refs


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             role: str = "program") -> dict:
    """One run of `cell`: the result line's object, `checks` last."""
    import numpy as np
    import torch

    from portbench import spec
    from portbench import trace as tracing
    from portbench.judge import verdict

    device = torch.device(device)
    cuda = device.type == "cuda"
    torch.set_num_threads(min(4, torch.get_num_threads()))
    marks = [("start", time.perf_counter())]
    model, program = prepare(cell, device, role)
    marks.append(("model and program", time.perf_counter()))
    batches = cell.kind.pool(cell.traffic, seed, device)
    marks.append(("pool", time.perf_counter()))
    loop = cell.kind.Loop(program, batches, cell.traffic, device)
    loop.warm(rounds=2)
    if cuda:
        torch.cuda.synchronize(device)
    marks.append(("warm", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    print("setup_s " + ", ".join(f"{name} {t - marks[i][1]:.3f}" for i, (name, t) in
                                 enumerate(marks[1:])) + f" after {marks[0][1] - t_start:.3f} "
          "of imports and the card's start", file=sys.stderr)
    rng = np.random.default_rng([int(seed), 1])
    tr = None
    if trace:
        span = min(seconds, TRACE_SECONDS)
        window, tr = tracing.traced(lambda mark: loop.run(span, rng, mark),
                                    warm=lambda: loop.warm(1))
    else:
        span = seconds
        window = loop.run(span, rng)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    run = Run(cell=cell, batches=batches, window=window, seconds=span, setup_s=setup_s, trace=tr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"], cell.bench_dir).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    attempted = sum(batches[s.batch].scans for s in window.steps)
    del program, loop
    if cuda:
        torch.cuda.empty_cache()
    numbers, failed, _ = judge_window(cell, model, batches, window)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": verdict(numbers, cell.limits), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {name: {"value": numbers[name], "limit": cell.limits[name]}
                        for name in cell.limits}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"the program {PROGRAM} is not in this checkout", file=sys.stderr)
        return 2
    from portbench.spec import load_cell

    cell = load_cell(ROOT, args.workload)
    cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"modules that a run may not load were loaded: {loaded}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
