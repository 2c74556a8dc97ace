"""Time of the fast modes on the card over batches, beside the einsums
they replaced, across source trees.

`mode="fast"` computes its three tables with `pipeline.folded_tables`
(float32) and, with `cube_dtype="int8"`, with `exact_tables` (float32
runs of exact integer sums). Each chooses between two routes from the
batch and the arena: the float32 route M1 in one product over a permuted
copy of the cube or one product a x (`pipeline.one_product_m1`), the
int8 route m1 and m3 over the batch's (scan, x) blocks or a x and in
runs of (x, y) (`pipeline.block_products_exact`, which also counts the
class rows). `--table` picks what is timed (CUDA events, the variants
interleaved, the median of the rounds), repeatable:

* ``steps`` (the default): for the demo model (3 classes) at the default
  arena and at 43 x 31 x 351, over the demo scans tiled to each batch
  with 4 target slots, each step's ms:
  ``exact``, ``fast``, ``fast_i8`` (the predictor's steps as the tree
  has them); ``fast_einsum``, ``fast_i8_einsum`` (the same predictors with
  the tables computed by the einsums they replaced: float32 einsums;
  float64 einsums of the int8 cube, exact integers, on the card);
  ``fast_one``, ``fast_per_x``, ``fast_i8_one``, ``fast_i8_per_x`` (each
  route forced, in trees that choose between them). At every batch it
  checks that `folded_tables_exact` equals the float64 einsums' integers
  bit for bit (and the CPU's int64 einsums up to 128 scans), under each
  route;
* ``classes``: the two table functions alone, each route forced, at 6,
  18 and 32 int8 template rows (3, 9 and 16 classes) and 64 to 2048
  random scans, at both arenas (`class_table`);
* ``class_steps``: the fast and fast int8 steps of random 3-, 9- and
  16-class models, each route forced, 64 to 1024 scans, both arenas
  (`class_steps`);
* ``export``: the demo model's fast and fast int8 predictors against
  their exported artifacts at 64 scans, both arenas (`export_table`).

Each `--tree` runs in a process of its own with that tree's package on
the path, in the order given (A B B A compares two trees in one call).

Usage (one CUDA card; from the root of a checkout):

    python radarml_tpu_torch/utils/route_bench.py --tree OLD --tree . --tree . --tree OLD
    python radarml_tpu_torch/utils/route_bench.py --table classes --table export

Prints one JSON line a process and writes them to `--out` (default
chiprun_out/route_bench.json).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys

SPECS = ("cxz,bxyz->bcy", "cyz,bxyz->bcx", "cxy,bxyz->bcz")
BATCHES = (1, 7, 64, 128, 256, 384, 512, 768, 1024, 2048, 4096)
FINE = dict(r_res=1.0, theta_res=2.0)  # 43 x 31 x 351
EXACT_CPU_MAX_B = 128


def einsum_tables(cubes, templates):
    """The fast path's float32 tables as einsums (before folded_tables)."""
    import torch

    return [None if t is None else torch.einsum(s, t, cubes) for s, t in zip(SPECS, templates)]


def einsum_tables_exact(cubes, quant):
    """The fast int8 path's raw tables as float64 einsums of the int8 cube
    (before folded_tables_exact): exact integers, every sum below 2^53,
    left in float64 as that path left them."""
    import torch

    v = cubes.to(torch.float64)
    return [None if q is None else torch.einsum(s, q.to(torch.float64), v)
            for s, q in zip(SPECS, quant)]


def _exact_name(pipeline) -> str:
    """The function a tree's fast int8 predictor calls for its tables."""
    return "exact_tables" if hasattr(pipeline, "exact_tables") else "folded_tables_exact"


def cuda_ms(fn, inner: int) -> float:
    """Mean ms of one fn() over `inner` back-to-back calls (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(inner):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / inner


def interleaved(fns: dict, inner: int, rounds: int) -> dict:
    """Median ms a call per name; names alternate order every round."""
    import torch

    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    names = list(fns)
    for r in range(rounds):
        for k in names if r % 2 == 0 else names[::-1]:
            times[k].append(cuda_ms(fns[k], inner))
    return {k: statistics.median(v) for k, v in times.items()}


@contextlib.contextmanager
def _patched(module, **attrs):
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def _call(pred, args, module=None, **attrs):
    """pred(*args) with `module`'s attributes patched for the call."""
    if module is None:
        return lambda: pred(*args)

    def run():
        with _patched(module, **attrs):
            return pred(*args)
    return run


def demo_inputs(dev, fine: bool, B: int):
    """The demo model's predictor kwargs and B of its scans (the 64
    synthetic demo scans tiled), float32 and int8 cubes, 4 slots."""
    import numpy as np
    import torch

    from radarml_tpu_torch.core.arena import DEFAULT_ARENA, Arena
    from radarml_tpu_torch.data.synthetic import make_scan_batch
    from radarml_tpu_torch.models.linear import from_numpy
    from radarml_tpu_torch.models.pipeline import encode_int8_cubes, pad_targets

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    g = dict(np.load(os.path.join(here, "assets", "demo_linear.npz")))
    arena = Arena(**FINE) if fine else DEFAULT_ARENA
    model, calib = from_numpy(g["coef"], g["intercept"], g["calib_a"], g["calib_b"], device=dev)
    kw = dict(train_arena=DEFAULT_ARENA, scan_arena=arena, model=model, calibration=calib,
              min_proba=float(g["min_proba"]), device=dev)
    cubes, targets = make_scan_batch(64, arena=arena, seed=int(g["scan_seed"]))
    xyz, valid = pad_targets([[(t.x, t.y, t.z)] for t in targets], max_targets=4)
    reps = -(-B // 64)
    f32 = torch.from_numpy(np.rint(cubes).astype(np.float32)).to(dev).repeat(reps, 1, 1, 1)[:B]
    xyz = torch.from_numpy(xyz).to(dev).repeat(reps, 1, 1)[:B]
    valid = torch.from_numpy(valid).to(dev).repeat(reps, 1)[:B]
    return kw, f32, encode_int8_cubes(f32), xyz, valid


ROUTES = {"one": 1 << 62, "per_x": 0}  # a route budget forcing each route


def forced(pipeline, route: str) -> dict:
    """The route budgets a tree has, each set to force `route`."""
    return {k: ROUTES[route] for k in ("M1_SLAB_BYTES", "EXACT_BLOCK_BYTES")
            if hasattr(pipeline, k)}


def exact_bits(pipeline, pred, i8) -> dict:
    """folded_tables_exact on the int8 cubes under each route the tree has
    against the float64 einsums' integers (and the CPU's int64 einsums
    up to EXACT_CPU_MAX_B scans): True where every entry is equal."""
    import torch

    quant = [None if q is None else pred._tensor(q[0])
             for q in pred._quantized_split_templates()]
    want = [None if w is None else w.to(torch.int64) for w in einsum_tables_exact(i8, quant)]
    routes = {"auto": {}}
    if hasattr(pipeline, "M1_SLAB_BYTES"):
        routes |= {r: forced(pipeline, r) for r in ROUTES}
    out = {}
    for name, attrs in routes.items():
        with _patched(pipeline, **attrs):
            got = pipeline.folded_tables_exact(i8, quant)
        out[name] = all(torch.equal(g, w) for g, w in zip(got, want))
    if i8.shape[0] <= EXACT_CPU_MAX_B:
        v = i8.cpu().to(torch.int64)
        cpu = [torch.einsum(s, q.cpu().to(torch.int64), v) for s, q in zip(SPECS, quant)]
        out["cpu_int64"] = all(torch.equal(g.cpu(), w) for g, w in zip(want, cpu))
    return out


def route_table(dev, fine: bool, batches=BATCHES, forced_routes: bool = True) -> dict:
    """{B: {"ms": {variant: ms}, "bits": {route: equal}}} at one arena, for
    the tree on the path (see the module's docstring). Host dispatch paces
    the small batches and spreads them: they take 21 rounds, the rest 5."""
    import torch

    from radarml_tpu_torch.models import pipeline
    from radarml_tpu_torch.models.pipeline import RadarPredictor

    out = {}
    for B in batches:
        kw, f32, i8, xyz, valid = demo_inputs(dev, fine, B)
        preds = {"exact": RadarPredictor(mode="exact", **kw),
                 "fast": RadarPredictor(mode="fast", **kw),
                 "fast_i8": RadarPredictor(mode="fast", cube_dtype="int8", **kw)}
        f, f8 = (f32, xyz, valid), (i8, xyz, valid)
        fns = {"exact": _call(preds["exact"], f), "fast": _call(preds["fast"], f),
               "fast_i8": _call(preds["fast_i8"], f8),
               "fast_einsum": _call(preds["fast"], f, pipeline, folded_tables=einsum_tables),
               "fast_i8_einsum": _call(preds["fast_i8"], f8, pipeline,
                                       **{_exact_name(pipeline): einsum_tables_exact})}
        if forced_routes and hasattr(pipeline, "M1_SLAB_BYTES"):
            for r in ROUTES:
                fns[f"fast_{r}"] = _call(preds["fast"], f, pipeline, **forced(pipeline, r))
                fns[f"fast_i8_{r}"] = _call(preds["fast_i8"], f8, pipeline,
                                            **forced(pipeline, r))
        inner = max(2, min(50, 8192 // B))
        out[B] = {"ms": interleaved(fns, inner=inner, rounds=21 if B <= 128 else 5),
                  "bits": exact_bits(pipeline, preds["fast_i8"], i8)}
        del kw, f32, i8, xyz, valid, preds, fns
        torch.cuda.empty_cache()
    return out


CLASS_ROWS = (6, 18, 32)  # C2 of 3, 9 and 16 classes (hi / lo rows a class)
CLASS_BATCHES = (64, 128, 256, 384, 512, 578, 768, 1024, 1536, 2048)


def class_table(dev, fine: bool, rows=CLASS_ROWS, batches=CLASS_BATCHES) -> dict:
    """{C2: {B: {variant: ms}}} at one arena: `exact_tables` on random int8
    cubes against random C2-row int8 templates of all three planes, and
    `folded_tables` on their float32 values against C2 / 2-row float32
    templates, each with each route forced ("exact_one", "exact_per_x",
    "f32_one", "f32_per_x"), and the route each takes unforced ("exact",
    "f32": "one" or "per_x")."""
    import torch

    from radarml_tpu_torch.core.arena import DEFAULT_ARENA, Arena
    from radarml_tpu_torch.models import pipeline

    dims = (Arena(**FINE) if fine else DEFAULT_ARENA).grid_shape
    X, Y, Z = dims
    gen = torch.Generator(device=dev).manual_seed(20)
    out = {}
    for C2 in rows:
        quant = [torch.randint(-127, 128, (C2,) + sh, generator=gen, device=dev,
                               dtype=torch.int8).to(torch.float32)
                 for sh in ((X, Z), (Y, Z), (X, Y))]
        templates = [torch.randn((C2 // 2,) + q.shape[1:], generator=gen, device=dev)
                     for q in quant]
        out[C2] = {}
        for B in batches:
            i8 = torch.randint(-128, 128, (B,) + dims, generator=gen, device=dev,
                               dtype=torch.int8)
            f32 = i8.to(torch.float32)
            fns = {}
            for r in ROUTES:
                fns[f"exact_{r}"] = _call(pipeline.exact_tables, (i8, quant), pipeline,
                                          **forced(pipeline, r))
                fns[f"f32_{r}"] = _call(pipeline.folded_tables, (f32, templates), pipeline,
                                        **forced(pipeline, r))
            ms = interleaved(fns, inner=max(2, min(20, 4096 // B)), rounds=5)
            ms["exact"] = "one" if pipeline.block_products_exact(i8.shape, [C2, C2]) else "per_x"
            ms["f32"] = "one" if pipeline.one_product_m1(i8.shape) else "per_x"
            out[C2][B] = ms
            del i8, f32, fns
            torch.cuda.empty_cache()
    return out


STEP_CLASSES = (3, 9, 16)
STEP_BATCHES = (64, 128, 256, 384, 512, 768, 1024)


def class_steps(dev, fine: bool, classes=STEP_CLASSES, batches=STEP_BATCHES) -> dict:
    """{C: {B: {variant: ms}}} at one arena: the fast and fast int8 steps
    of a random C-class linear model (trained at the default arena) on the
    demo scans tiled to B with 4 slots, each route forced ("fast_one",
    "fast_per_x", "fast_i8_one", "fast_i8_per_x"), and the route each
    takes unforced ("fast", "fast_i8": "one" or "per_x")."""
    import numpy as np
    import torch

    from radarml_tpu_torch.core.arena import DEFAULT_ARENA
    from radarml_tpu_torch.models import pipeline
    from radarml_tpu_torch.models.linear import from_numpy
    from radarml_tpu_torch.models.pipeline import RadarPredictor

    out = {}
    for C in classes:
        rng = np.random.default_rng(C)
        F = DEFAULT_ARENA.feature_length
        weights = ((rng.normal(size=(C, F)) * 0.01).astype(np.float32),
                   rng.normal(size=C).astype(np.float32),
                   -rng.uniform(0.5, 2.0, size=C).astype(np.float32),
                   (rng.normal(size=C) * 0.1).astype(np.float32))
        model, calib = from_numpy(*weights, device=dev)
        out[C] = {}
        for B in batches:
            kw, f32, i8, xyz, valid = demo_inputs(dev, fine, B)
            kw = dict(kw, model=model, calibration=calib)
            fast = RadarPredictor(mode="fast", **kw)
            fast_i8 = RadarPredictor(mode="fast", cube_dtype="int8", **kw)
            fns = {}
            for r in ROUTES:
                fns[f"fast_{r}"] = _call(fast, (f32, xyz, valid), pipeline, **forced(pipeline, r))
                fns[f"fast_i8_{r}"] = _call(fast_i8, (i8, xyz, valid), pipeline,
                                            **forced(pipeline, r))
            ms = interleaved(fns, inner=max(2, min(20, 4096 // B)), rounds=5)
            shape = tuple(i8.shape)
            ms["fast"] = "one" if pipeline.one_product_m1(shape) else "per_x"
            ms["fast_i8"] = ("one" if pipeline.block_products_exact(shape, [2 * C, 2 * C])
                             else "per_x")
            out[C][B] = ms
            del kw, f32, i8, xyz, valid, fast, fast_i8, fns
            torch.cuda.empty_cache()
    return out


def export_table(dev, fine: bool, tmp: str, B: int = 64) -> dict:
    """ms a step at B scans of the demo model's fast and fast int8
    predictors and of their exported artifacts (serving.export_predictor,
    a symbolic batch), each artifact's outputs checked equal to its live
    predictor's."""
    import torch

    from radarml_tpu_torch.models.pipeline import RadarPredictor
    from radarml_tpu_torch.serving import export_predictor, load_serving_artifact

    kw, f32, i8, xyz, valid = demo_inputs(dev, fine, B)
    fns, equal = {}, {}
    for name, cube_dtype, cubes in (("fast", "float32", f32), ("fast_i8", "int8", i8)):
        live = RadarPredictor(mode="fast", cube_dtype=cube_dtype, **kw)
        path = os.path.join(tmp, f"{name}_{int(fine)}.rmlx")
        export_predictor(live, path, max_targets=xyz.shape[1])
        art = load_serving_artifact(path, device=dev)
        args = (cubes, xyz, valid)
        equal[name] = all(torch.equal(a, b) for a, b in zip(live(*args), art(*args)))
        fns[f"{name}_live"], fns[f"{name}_artifact"] = _call(live, args), _call(art, args)
    return {"B": B, "equal": equal, **interleaved(fns, inner=50, rounds=21)}


def run_one(tables, batches, forced_routes: bool) -> dict:
    import tempfile

    import torch

    from radarml_tpu_torch.models import pipeline

    dev = torch.device("cuda")
    res = {k.lower(): getattr(pipeline, k, None) for k in ("M1_SLAB_BYTES", "EXACT_BLOCK_BYTES")}
    for name, fine in (("22x31x176", False), ("43x31x351", True)):
        if "steps" in tables:
            res[name] = route_table(dev, fine, batches, forced_routes)
        if "classes" in tables:
            res[f"classes_{name}"] = class_table(dev, fine)
        if "class_steps" in tables:
            res[f"class_steps_{name}"] = class_steps(dev, fine)
        if "export" in tables:
            with tempfile.TemporaryDirectory() as tmp:
                res[f"export_{name}"] = export_table(dev, fine, tmp)
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", help="a checkout to time (repeatable)")
    p.add_argument("--table", action="append", choices=("steps", "classes", "class_steps", "export"),
                   help="what to time (repeatable; default: steps)")
    p.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    p.add_argument("--no-forced", action="store_true", help="skip the forced routes")
    p.add_argument("--out", default=os.path.join("chiprun_out", "route_bench.json"))
    p.add_argument("--one", help=argparse.SUPPRESS)  # the child process: its tree
    args = p.parse_args(argv)
    tables = args.table or ["steps"]
    if args.one is not None:
        print(json.dumps(run_one(tables, args.batches, not args.no_forced)), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    lines = []
    for tree in args.tree or ["."]:
        tree = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [tree] + [q for q in os.environ.get("PYTHONPATH", "").split(os.pathsep) if q]))
        cmd = [sys.executable, os.path.abspath(__file__), "--one", tree, "--batches",
               *map(str, args.batches), *(f"--table={t}" for t in tables)]
        cmd += ["--no-forced"] if args.no_forced else []
        done = subprocess.run(cmd, env=env, cwd=tree, capture_output=True, text=True)
        if done.returncode != 0:
            raise SystemExit(f"{tree} failed:\n{done.stderr[-3000:]}")
        line = {"tree": tree, "card": smi.strip(), **json.loads(done.stdout.splitlines()[-1])}
        print(json.dumps(line), flush=True)
        lines.append(line)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main()
