"""Host cost of reaching a kernel through its torch op, on the card.

Every live kernel call goes through a torch op (ops/library.py). This
script times, with CUDA events, the combo kernel's (B1) call at B=64,
where the host bounds the call, and the fused combo predict step at
B=128, in two ways:

* in one process, interleaved round by round: the public wrapper (through
  its op), the same wrapper with the op's CUDA implementation called
  directly (the path before the ops existed), and the same implementation
  registered as a `torch.library.custom_op` under a namespace of its own;
* across source trees (`--tree`, one process each, in the order given),
  for a tree before the ops existed against this one: the wrapper and the
  step only.

Usage (one CUDA card; run from the root of a checkout):

    python radarml_tpu_torch/utils/op_dispatch.py --rounds 40
    python radarml_tpu_torch/utils/op_dispatch.py --tree OLD --tree . --tree . --tree OLD

Prints one JSON line for each process (medians, quartiles and minima over
the rounds; in one process also each path minus the wrapper, round by
round, the steps again with the garbage collector off, and where each
step's host time goes) and, with --tree, one summary line per tree, and
writes them all to chiprun_out/op_dispatch.json.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys

B_CALL, B_STEP = 64, 128
INNER_CALL, INNER_STEP = 200, 40


def _timed(fn, inner: int) -> float:
    """Milliseconds a call of `fn` over `inner` back-to-back calls."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(inner):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / inner


def _interleaved(fns: dict, inner: int, rounds: int) -> dict:
    """Each round times every entry once, the order rotating by a step a
    round; returns each entry's per-round times."""
    names = list(fns)
    for fn in fns.values():  # warm: build, plan, caches
        fn()
    out = {n: [] for n in names}
    for r in range(rounds):
        for n in names[r % len(names):] + names[:r % len(names)]:
            out[n].append(_timed(fns[n], inner))
    return out


def _summary(times: list) -> dict:
    q = statistics.quantiles(times, n=4)
    return {"median": statistics.median(times), "q1": q[0], "q3": q[2],
            "min": min(times), "rounds": len(times)}


def _where(step, n: int = 200) -> dict:
    """Where a step's host time goes: the garbage collector's passes and
    milliseconds over `n` steps, and from a torch.profiler trace of 20
    steps the CUDA runtime's synchronising calls and the five host
    entries with the most self time (µs a step)."""
    import time

    import torch

    clock, spent = [0.0], {"passes": 0, "ms": 0.0}

    def collected(phase, info):
        if phase == "start":
            clock[0] = time.perf_counter()
        else:
            spent["passes"] += 1
            spent["ms"] += (time.perf_counter() - clock[0]) * 1e3

    gc.callbacks.append(collected)
    try:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    finally:
        gc.callbacks.remove(collected)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(20):
            step()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    top = sorted(rows, key=lambda r: r.self_cpu_time_total, reverse=True)[:5]
    return {"gc_passes_per_step": spent["passes"] / n, "gc_ms_per_step": spent["ms"] / n,
            "syncs_per_step": sum(r.count for r in rows
                                  if "Synchronize" in r.key or "Memcpy" in r.key) / 20,
            "host_self_us_per_step": sum(r.self_cpu_time_total for r in rows) / 20,
            "top_self_us_per_step": {r.key: r.self_cpu_time_total / 20 for r in top}}


def measure(rounds: int) -> dict:
    """The measurements of the `radarml_tpu_torch` on sys.path."""
    import numpy as np
    import torch

    from radarml_tpu_torch.core.arena import DEFAULT_ARENA
    from radarml_tpu_torch.data.synthetic import make_scan_batch
    from radarml_tpu_torch.models.linear import from_numpy
    from radarml_tpu_torch.models.pipeline import RadarPredictor, pad_targets
    from radarml_tpu_torch.ops import i8_score

    import radarml_tpu_torch

    dev = torch.device("cuda", 0)
    root = os.path.dirname(os.path.dirname(os.path.abspath(radarml_tpu_torch.__file__)))
    g = dict(np.load(os.path.join(root, "radarml_tpu_torch", "assets", "demo_linear.npz")))
    model, calib = from_numpy(g["coef"], g["intercept"], g["calib_a"], g["calib_b"],
                              device=dev)
    p = RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, model, calib,
                       min_proba=float(g["min_proba"]), mode="fused", device=dev)
    cubes, targets = make_scan_batch(B_STEP, seed=int(g["scan_seed"]))
    xyz, valid = pad_targets([[(t.x, t.y, t.z)] for t in targets], 4)
    w = i8_score.build_combined_weights(p._quantized_split_templates(),
                                        DEFAULT_ARENA.grid_shape, device=dev)
    c64 = i8_score.encode_int8_cubes(np.rint(cubes[:B_CALL]), dev).contiguous()
    c128 = i8_score.encode_int8_cubes(np.rint(cubes), dev).contiguous()
    x, v = torch.from_numpy(xyz).to(dev), torch.from_numpy(valid).to(dev)

    calls = {"wrapper": lambda: i8_score.onepass_tables_combined_i8(c64, w)}
    steps = {"wrapper": lambda: p._fn(c128, x, v)}
    has_ops = hasattr(i8_score, "combo_tables_cuda")
    if has_ops:
        from radarml_tpu_torch.ops import library

        def direct(cube, q_xz, q_yz, q_xy, levels):
            return i8_score.combo_tables_cuda(cube, library._weights(cube, q_xz, q_yz, q_xy,
                                                                     levels))

        torch.library.custom_op(
            "radarml_dispatch_probe::combo", direct, mutates_args=(), device_types="cuda",
            schema="(Tensor cube, Tensor? q_xz, Tensor? q_yz, Tensor? q_xy, int levels) "
                   "-> (Tensor, Tensor, Tensor)")

        planes = (w.q_xz, w.q_yz, w.q_xy, w.levels)

        def laid_out(tables):
            return tuple(t.permute(1, 2, 0) for t in tables)

        def no_op():
            i8_score.check_operands(c64, w)
            return laid_out(direct(c64, *planes))

        def custom_op():
            i8_score.check_operands(c64, w)
            return laid_out(torch.ops.radarml_dispatch_probe.combo(c64, *planes))

        calls |= {"no_op": no_op, "custom_op": custom_op}
        # The fused step with the name its wrapper calls bound to each path
        # in turn (every step rebinds it, so all three pay the same).
        ns, op = torch.ops.radarml_torch, torch.ops.radarml_torch.combo_tables_i8

        def bound_to(fn):
            def step():
                setattr(ns, "combo_tables_i8", fn)
                return p._fn(c128, x, v)
            return step

        steps = {"wrapper": bound_to(op), "no_op": bound_to(direct),
                 "custom_op": bound_to(torch.ops.radarml_dispatch_probe.combo)}
    try:
        want = steps["wrapper"]()
        for name, step in steps.items():  # the same answers every way
            if not all(torch.equal(a, b) for a, b in zip(want, step())):
                raise RuntimeError(f"the fused step through {name} differs")
        with torch.no_grad():
            call_ms = _interleaved(calls, INNER_CALL, rounds)
            step_ms = _interleaved(steps, INNER_STEP, rounds)
            if has_ops:
                gc.disable()
                try:
                    nogc_ms = _interleaved(steps, INNER_STEP, rounds)
                finally:
                    gc.enable()
                where = {name: _where(step) for name, step in steps.items()}
    finally:
        if has_ops:
            setattr(ns, "combo_tables_i8", op)
    out = {"tree": root, "ops": has_ops}
    timed = [(f"call_B{B_CALL}_ms", call_ms), (f"step_B{B_STEP}_ms", step_ms)]
    if has_ops:
        timed.append((f"step_B{B_STEP}_ms_gc_off", nogc_ms))
        out[f"step_B{B_STEP}_host"] = where
    for key, times in timed:
        out[key] = {k: _summary(t) for k, t in times.items()}
        # each other path against the wrapper in the same round
        out[key + "_minus_wrapper"] = {
            k: _summary([a - b for a, b in zip(t, times["wrapper"])])
            for k, t in times.items() if k != "wrapper"}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout to measure in a process of its own; repeat, "
                         "in the order to run them")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "op_dispatch.json"))
    ap.add_argument("--child", action="store_true",
                    help="measure the checkout on PYTHONPATH (how --tree runs each)")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card, flush=True)
    if not args.tree:
        if not args.child:  # this file's checkout
            sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))))
        runs = [measure(args.rounds)]
        print(json.dumps(runs[0]), flush=True)
    else:
        runs = []
        for tree in args.tree:
            tree = os.path.abspath(tree)
            env = dict(os.environ, PYTHONPATH=tree)
            got = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", "--rounds",
                 str(args.rounds), "--out", os.devnull], cwd=tree, env=env, capture_output=True, text=True)
            if got.returncode != 0:
                sys.stderr.write(got.stdout + got.stderr)
                raise SystemExit(f"the process in {tree} failed")
            runs.append(json.loads(got.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
        for tree in dict.fromkeys(r["tree"] for r in runs):
            mine = [r for r in runs if r["tree"] == tree]
            line = {"tree": tree, "processes": len(mine)}
            for key in (f"call_B{B_CALL}_ms", f"step_B{B_STEP}_ms"):
                med = [r[key]["wrapper"]["median"] for r in mine]
                line[key] = {"median_of_medians": statistics.median(med),
                             "min": min(med), "max": max(med), "each": med}
            print(json.dumps(line), flush=True)
            runs.append(line)
    if args.out != os.devnull:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fp:
            json.dump({"card": card, "runs": runs}, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
