"""Drive the PyTorch port's predict path on one CUDA card.

    python3 chip_smoke.py

Phases, one line of findings each; any failure raises (non-zero exit):

1. device  — a CUDA card is present; its name and power limit.
2. build   — the one-pass int8 table kernel (radarml_tpu_torch/ops/csrc/
             i8_score.cu) is compiled from the checkout's source by nvcc.
3. kernel  — the kernel's int32 tables equal its plain PyTorch version
             (torch.equal) at the default arena: random int8 cubes at
             B=256 and B=4096, levels 2 and 1, and one masked plane.
4. slice   — the demo model (radarml_tpu_torch/assets/demo_linear.npz)
             scores 512 synthetic scans (4 target slots each) through
             RadarPredictor in exact, fast f32, fast int8, fused split
             and fused single modes. Fused split decisions equal fast
             int8's (probabilities within 1e-6); the first 64 scans
             agree with the JAX package's golden outputs (decisions
             equal where the top-2 margin exceeds 1e-4, probabilities
             within 1e-5; fast f32 within 2e-4 of exact, the JAX
             package's own fast-vs-exact bar). The cube indices of
             40,000 targets computed on the card are compared with the
             CPU's, and the count that differ is reported.
5. serving — a StreamingClassifier over the fused predictor answers every
             scan of a synthetic source with predict_errors == 0 and the
             detections of a direct call.
6. timing  — CUDA events, warm-up, median of rounds, batch tiled to 4096:
             the kernel against its plain version, and fused / fast int8
             / exact scans per second with inputs resident on the card.

The kernel's launch count is reset just before phases 4-5 (the main
path) and read just after them. The line before last is the kernel
record as JSON; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from radarml_tpu_torch.core.arena import DEFAULT_ARENA  # noqa: E402
from radarml_tpu_torch.data.synthetic import make_scan_batch  # noqa: E402
from radarml_tpu_torch.models.linear import from_numpy  # noqa: E402
from radarml_tpu_torch.models.pipeline import RadarPredictor, pad_targets  # noqa: E402
from radarml_tpu_torch.ops import _cuda_build  # noqa: E402
from radarml_tpu_torch.ops import i8_score  # noqa: E402
from radarml_tpu_torch.serving.stream import StreamConfig, StreamingClassifier  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(HERE, "radarml_tpu_torch", "assets", "demo_linear.npz")
KERNEL_SOURCE = "radarml_tpu_torch/ops/csrc/i8_score.cu"
REPLACES = "radarml_tpu/ops/pallas_i8_score.py:804"
N_SLICE, BIG = 512, 4096
GOLDEN_DECISION_MARGIN = 1e-4


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def margin_ok(proba: np.ndarray, best: np.ndarray, min_proba: float) -> np.ndarray:
    top2 = np.sort(proba, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0] > GOLDEN_DECISION_MARGIN) & (
        np.abs(best - min_proba) > GOLDEN_DECISION_MARGIN
    )


def cuda_ms(fn, inner: int) -> float:
    """Mean ms of one fn() over `inner` back-to-back calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(inner):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / inner


def interleaved(fns: dict, inner: int, rounds: int) -> dict:
    """Median ms per name; names alternate order every round."""
    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    names = list(fns)
    for r in range(rounds):
        for k in names if r % 2 == 0 else names[::-1]:
            times[k].append(cuda_ms(fns[k], inner))
    return {k: statistics.median(v) for k, v in times.items()}


def random_quant(rng, dims, levels, masked=None, C=3):
    X, Y, Z = dims
    out = []
    for p, shape in enumerate(((X, Z), (Y, Z), (X, Y))):
        if p == masked:
            out.append(None)
            continue
        q = rng.integers(-127, 128, (levels * C,) + shape).astype(np.int8)
        s = np.ones((C,), np.float32)
        out.append((q, s, s if levels == 2 else None, s))
    return out


def main() -> None:
    # -- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card only")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build ---------------------------------------------------------
    stale = _cuda_build.library_path("i8_score")
    if stale.exists():
        stale.unlink()  # always compile this checkout's source
    t0 = time.perf_counter()
    i8_score._library()
    say("build", f"i8_score.cu -> {stale.name} by nvcc sm_90a in "
        f"{time.perf_counter() - t0:.2f} s")

    # -- 3. kernel vs plain -----------------------------------------------
    dims = DEFAULT_ARENA.grid_shape
    rng = np.random.default_rng(0)
    max_err = 0
    cases = [(256, 2, None), (256, 1, None), (256, 2, 1), (BIG, 2, None), (BIG, 1, None)]
    for B, levels, masked in cases:
        w = i8_score.build_combined_weights(
            random_quant(rng, dims, levels, masked), dims, levels=levels, device=dev
        )
        cube = torch.from_numpy(
            rng.integers(-128, 128, (B,) + dims, dtype=np.int8)
        ).to(dev)
        got = i8_score.onepass_tables_combined_i8(cube, w)
        torch.cuda.synchronize()
        want = i8_score.onepass_tables_combined_i8_ref(cube, w)
        for g, r in zip(got, want):
            check(g.shape == r.shape and g.dtype == torch.int32, "table shape/dtype")
            max_err = max(max_err, int((g.long() - r.long()).abs().max()))
            check(torch.equal(g, r), f"kernel != plain at B={B} levels={levels} "
                  f"masked={masked}")
        if masked is not None:
            check(not got[masked].any(), "masked plane gave a non-zero table")
    say("kernel", f"tables equal the plain version in {len(cases)} cases "
        f"(B 256/4096, levels 2/1, masked yz plane); max_abs_err {max_err}; "
        f"x-slab {i8_score.slab_width(w)} of {dims[0]}")

    # -- 4. the slice -----------------------------------------------------
    g = dict(np.load(ASSET))
    min_proba = float(g["min_proba"])
    model, calib = from_numpy(g["coef"], g["intercept"], g["calib_a"], g["calib_b"],
                              device=dev)
    kw = dict(train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA, model=model,
              calibration=calib, min_proba=min_proba, device=dev)
    cubes, targets = make_scan_batch(N_SLICE, seed=int(g["scan_seed"]))
    cubes = np.rint(cubes)
    xyz, valid = pad_targets([[(t.x, t.y, t.z)] for t in targets],
                             max_targets=int(g["max_targets"]))
    preds = {
        "exact": RadarPredictor(mode="exact", **kw),
        "fast": RadarPredictor(mode="fast", **kw),
        "fast_i8": RadarPredictor(mode="fast", cube_dtype="int8", **kw),
        "fused": RadarPredictor(mode="fused", **kw),
        "fused_single": RadarPredictor(mode="fused", fused_quant="single", **kw),
    }
    i8_score.KERNEL_LAUNCHES = 0  # count the main path's launches only
    out = {}
    for name, p in preds.items():
        src = p.pack_host(cubes.astype(np.uint8)) if p.mode == "fused" else cubes
        res = p(src, xyz, valid)
        check(all(r.device.type == "cuda" for r in res), f"{name} left the card")
        out[name] = [r.cpu().numpy() for r in res]
    for name, (pr, best, proba) in out.items():
        check(pr.shape == (N_SLICE, 4) and proba.shape == (N_SLICE, 4, 3),
              f"{name} shapes")
        check(np.isfinite(proba).all() and np.isfinite(best).all(), f"{name} finite")
        check((pr[~valid] == -1).all(), f"{name} padded slots not UNKNOWN")
    check(np.array_equal(out["fused"][0], out["fast_i8"][0]),
          "fused split decisions != fast int8 decisions")
    d_fused_fast = float(np.abs(out["fused"][2] - out["fast_i8"][2]).max())
    check(d_fused_fast <= 1e-6, f"fused vs fast int8 proba delta {d_fused_fast}")
    n = int(g["n_scans"])
    golden = []
    for name, ref, atol in (("exact", "exact", 1e-5), ("fused", "fused", 1e-5),
                            ("fast_i8", "fused", 1e-5), ("fast", "exact", 2e-4)):
        pr, _, proba = (a[:n] for a in out[name])
        ok = margin_ok(g[f"{ref}_proba"], g[f"{ref}_best"], min_proba)
        delta = float(np.abs(proba - g[f"{ref}_proba"]).max())
        check(delta <= atol, f"{name} vs JAX {ref} golden: proba delta {delta} > {atol}")
        check(np.array_equal(pr[ok], g[f"{ref}_pred"][ok]),
              f"{name} decisions differ from the JAX {ref} golden")
        golden.append(f"{name}~{ref} {delta:.2e} "
                      f"({int((ok & valid[:n]).sum())} of {int(valid[:n].sum())} decided)")
    d_single = float(np.abs(out["fused_single"][2] - out["fused"][2]).max())
    say("slice", f"{N_SLICE} scans x 4 slots through exact/fast/fast_i8/fused/"
        f"fused_single on {dev}; fused==fast_i8 decisions, proba delta "
        f"{d_fused_fast:.2e}; golden (first {n}): " + ", ".join(golden)
        + f"; fused_single vs split proba delta {d_single:.2e}")
    # float32 trig on the card may round differently from the CPU: count
    # the truncated cube indices that differ (reported, not fatal).
    cells = np.stack([rng.integers(0, s, 20000) for s in dims]).astype(np.float64)
    nodes = np.stack(DEFAULT_ARENA.grid_to_cartesian_np(*cells), -1)
    pts = np.concatenate([nodes, nodes + rng.normal(scale=1.0, size=nodes.shape)])
    pts = torch.from_numpy(pts.astype(np.float32))
    on_cpu = DEFAULT_ARENA.clamped_matrix_indices(*pts.T)
    on_dev = DEFAULT_ARENA.clamped_matrix_indices(*pts.to(dev).T)
    n_diff = int(sum((a != b.cpu()).sum() for a, b in zip(on_cpu, on_dev)))
    say("indices", f"{len(pts)} targets (grid nodes and jittered): {n_diff} "
        f"cube indices differ between {dev} and the CPU")

    # -- 5. serving -------------------------------------------------------
    fused = preds["fused"]
    u8 = cubes.astype(np.uint8)
    lock = threading.Lock()
    sent = []

    def source():
        with lock:
            s = len(sent)
            if s < N_SLICE:
                sent.append(s)
        if s >= N_SLICE:
            time.sleep(0.001)  # wait like a sensor between frames
            return None
        return u8[s], [(targets[s].x, targets[s].y, targets[s].z)]

    dets = []
    svc = StreamingClassifier(
        fused, StreamConfig(max_batch=64, max_wait_s=0.005,
                            queue_depth=N_SLICE + 1, max_targets=4),
        on_detection=dets.append,
    )
    t0 = time.perf_counter()
    svc.start(source)
    deadline = time.monotonic() + 300.0
    while len(dets) < N_SLICE and time.monotonic() < deadline:
        time.sleep(0.01)
    svc.stop()
    wall = time.perf_counter() - t0
    st = svc.stats()
    launches = i8_score.KERNEL_LAUNCHES
    check(st["predict_errors"] == 0, f"predict_errors {st['predict_errors']}")
    check(st["processed"] == N_SLICE and len(dets) == N_SLICE,
          f"answered {len(dets)} of {N_SLICE} scans")
    pr, best, _ = out["fused"]
    for d in dets:
        check(d.label_index == pr[d.seq, 0], f"stream label differs at scan {d.seq}")
        check(abs(d.proba - best[d.seq, 0]) <= 1e-6, f"stream proba differs at {d.seq}")
    check(launches > 0, "the main path launched the kernel no time")
    say("serving", f"stream answered {len(dets)}/{N_SLICE} scans in {wall:.2f} s, "
        f"predict_errors 0, dropped {st['dropped']}, mean batch "
        f"{st['mean_batch']:.1f}, detections == direct call; kernel launches "
        f"in phases 4-5: {launches}")

    # -- 6. timing --------------------------------------------------------
    tiled = np.tile(cubes, (BIG // N_SLICE, 1, 1, 1))
    txyz = torch.from_numpy(np.tile(xyz, (BIG // N_SLICE, 1, 1))).to(dev)
    tvalid = torch.from_numpy(np.tile(valid, (BIG // N_SLICE, 1))).to(dev)
    packed = fused.pack_host(tiled.astype(np.uint8)).to(dev)
    kernel_ms = {}
    for levels, name in ((2, "fused"), (1, "fused_single")):
        w = i8_score.build_combined_weights(
            preds[name]._quantized_split_templates(levels), dims,
            levels=levels, device=dev,
        )
        kernel_ms[levels] = interleaved({
            "plain": lambda w=w: i8_score.onepass_tables_combined_i8_ref(packed, w),
            "kernel": lambda w=w: i8_score.onepass_tables_combined_i8(packed, w),
        }, inner=5, rounds=5)
    inputs = {
        "fused": packed,
        "fast_i8": packed,
        "exact": torch.from_numpy(tiled.astype(np.float32)).to(dev),
    }
    step_ms = interleaved(
        {k: (lambda k=k: preds[k](inputs[k], txyz, tvalid)) for k in inputs},
        inner=3, rounds=5,
    )
    rates = {k: BIG / (v / 1e3) for k, v in step_ms.items()}
    say("timing", f"B={BIG} on {smi}: kernel split {kernel_ms[2]['kernel']:.4f} ms "
        f"vs plain {kernel_ms[2]['plain']:.4f} ms; kernel single "
        f"{kernel_ms[1]['kernel']:.4f} ms vs plain {kernel_ms[1]['plain']:.4f} ms; "
        + "; ".join(f"{k} {rates[k]:.0f} scans/s ({step_ms[k]:.4f} ms/batch)"
                    for k in inputs))

    print(json.dumps({"kernels": [{
        "name": "onepass_tables_combined_i8",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms[2]["kernel"],
        "plain_ms": kernel_ms[2]["plain"],
        "ms_single": kernel_ms[1]["kernel"],
        "plain_ms_single": kernel_ms[1]["plain"],
        "scans_per_s": rates,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
