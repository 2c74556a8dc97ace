"""Drive the PyTorch port's predict and SVC paths on one CUDA card.

    python3 chip_smoke.py

Phases, one line of findings each; any failure raises (non-zero exit):

1. device  — a CUDA card is present; its name and power limit.
2. build   — both hand-written kernels (radarml_tpu_torch/ops/csrc/
             i8_score.cu and rbf_gram.cu) are compiled from the
             checkout's sources by nvcc, one process per source, all
             started together.
3. kernel  — the int8 table kernel's tables equal its plain PyTorch
             version (torch.equal) at the default arena: random int8
             cubes at B=256 and B=4096, levels 2 and 1, one masked plane.
4. slice   — the demo linear model (radarml_tpu_torch/assets/
             demo_linear.npz) scores 512 synthetic scans (4 target slots
             each) through RadarPredictor in exact, fast f32, fast int8,
             fused split and fused single modes. Fused split decisions
             equal fast int8's (probabilities within 1e-6); the first 64
             scans agree with the JAX package's golden outputs (decisions
             equal where the top-2 margin exceeds 1e-4, probabilities
             within 1e-5; fast f32 within 2e-4 of exact, the JAX
             package's own fast-vs-exact bar). The cube indices of 40,000
             targets computed on the card are compared with the CPU's,
             and the count that differ is reported.
5. serving — a StreamingClassifier over the fused predictor answers every
             scan of a synthetic source with predict_errors == 0 and the
             detections of a direct call.
6. timing  — CUDA events, warm-up, median of rounds, batch tiled to 4096:
             the int8 kernel against its plain version, and fused / fast
             int8 / exact scans per second with inputs resident on the card.
7. rbf     — the RBF Gram kernel against its plain version and a float64
             oracle, on scaled features of the SVC dataset (process_samples
             (scale=True) of make_dataset(1824, hardness=1.0)) and on
             uniform [0, 1] rows (against exact copies of themselves where
             the shape allows), at the serving shape (16,384 queries x
             the 1,823 support vectors x 10,010), the training shape
             (1824 x 1824 x 10,010), a ragged one (37 x 23 x 50) and an odd
             F (300 x 200 x 10,009, misaligned rows), gamma 0.001 / 0.01 /
             0.1: its error against float64 is at most 2x the plain float32
             version's + 1e-6. A non-contiguous input raises.
8. svc fit — svc_fit (C=10, gamma=0.01, rbf, probability) on that dataset
             on the card: SMO iterations per problem, seconds, n_sv, and
             agreement with the JAX-fitted SVC of radarml_tpu_torch/assets/
             demo_svc.npz (decisions within atol 5e-3 / rtol 1e-2 and >= 98%
             equal predictions, the bar of tests/test_svc.py:86-87).
9. svc     — the JAX-fitted SVC, carried across with the port's own
             support vectors, scores the 512 scans of phase 4 through
             RadarPredictor(mode="exact") on the card: padded slots are
             UNKNOWN, fast equals exact, and the first 64 scans agree with
             the JAX golden outputs and with the port on the CPU (decisions
             equal where the top-2 margin exceeds 1e-3, probabilities
             within 1e-3). A StreamingClassifier over it answers 128 scans
             with predict_errors == 0 and the detections of a direct call.
10. svc timing — rbf kernel against plain at the serving and training
             shapes, SVC exact scans per second at B=4096 and where its time
             goes, and svc_fit seconds (warm).

Each kernel's launch count is reset just before its main path and read
just after: the int8 kernel over phases 4-5, the RBF kernel over phase 9
(and, reported apart, over the fit of phase 8). The line before last is
the kernel record as JSON; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from radarml_tpu_torch.core.arena import DEFAULT_ARENA  # noqa: E402
from radarml_tpu_torch.data.synthetic import make_dataset, make_scan_batch  # noqa: E402
from radarml_tpu_torch.models import svc  # noqa: E402
from radarml_tpu_torch.models.linear import from_numpy  # noqa: E402
from radarml_tpu_torch.models.pipeline import RadarPredictor, pad_targets  # noqa: E402
from radarml_tpu_torch.ops import _cuda_build  # noqa: E402
from radarml_tpu_torch.ops import i8_score, rbf  # noqa: E402
from radarml_tpu_torch.ops.features import process_samples  # noqa: E402
from radarml_tpu_torch.serving.stream import StreamConfig, StreamingClassifier  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(HERE, "radarml_tpu_torch", "assets", "demo_linear.npz")
SVC_ASSET = os.path.join(HERE, "radarml_tpu_torch", "assets", "demo_svc.npz")
KERNEL_SOURCE = "radarml_tpu_torch/ops/csrc/i8_score.cu"
REPLACES = "radarml_tpu/ops/pallas_i8_score.py:804"
RBF_SOURCE = "radarml_tpu_torch/ops/csrc/rbf_gram.cu"
RBF_REPLACES = "radarml_tpu/ops/pallas_rbf.py:29"
N_SLICE, BIG = 512, 4096
GOLDEN_DECISION_MARGIN = 1e-4
# The SVC's probabilities go through a 1823-term Gram row, the pair
# product and the coupling loop, each summed in another order on the card
# than in XLA on the CPU; 1e-3 is the stated probability tolerance (the
# run prints the bound the measured Gram error implies), and decisions are
# compared where the top-2 margin exceeds it.
SVC_MARGIN, SVC_PROBA_ATOL = 1e-3, 1e-3
N_STREAM_SVC = 128
GAMMAS = (0.001, 0.01, 0.1)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def margin_ok(proba: np.ndarray, best: np.ndarray, min_proba: float,
              margin: float = GOLDEN_DECISION_MARGIN) -> np.ndarray:
    top2 = np.sort(proba, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0] > margin) & (
        np.abs(best - min_proba) > margin
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


def drive_stream(predictor, u8, targets, n: int):
    """Serve the first n scans (one target each) through a
    StreamingClassifier; returns (detections, stats, wall seconds)."""
    lock = threading.Lock()
    sent = []

    def source():
        with lock:
            s = len(sent)
            if s < n:
                sent.append(s)
        if s >= n:
            time.sleep(0.001)  # wait like a sensor between frames
            return None
        return u8[s], [(targets[s].x, targets[s].y, targets[s].z)]

    dets = []
    stream = StreamingClassifier(
        predictor, StreamConfig(max_batch=64, max_wait_s=0.005,
                                queue_depth=n + 1, max_targets=4),
        on_detection=dets.append,
    )
    t0 = time.perf_counter()
    stream.start(source)
    deadline = time.monotonic() + 300.0
    while len(dets) < n and time.monotonic() < deadline:
        time.sleep(0.01)
    stream.stop()
    return dets, stream.stats(), time.perf_counter() - t0


def rbf_errors(X, S, gammas):
    """Max |K - K64| of the kernel and of the plain version per gamma,
    against a float64 oracle of the same formula."""
    X64, S64 = X.double(), S.double()
    d2 = ((X64 * X64).sum(1)[:, None] + (S64 * S64).sum(1)[None, :]
          - 2.0 * (X64 @ S64.T)).clamp(min=0.0)
    del X64, S64
    out = []
    for g in gammas:
        k = rbf.rbf_gram(X, S, g)
        torch.cuda.synchronize()
        oracle = torch.exp(-g * d2)
        ek = float((k.double() - oracle).abs().max())
        er = float((rbf.rbf_gram_ref(X, S, g).double() - oracle).abs().max())
        out.append((g, ek, er))
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
    sources = ("i8_score", "rbf_gram")
    for name in sources:
        stale = _cuda_build.library_path(name)
        if stale.exists():
            stale.unlink()  # always compile this checkout's sources
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        built = list(pool.map(_cuda_build.build, sources))
    i8_score._library()
    rbf._library()
    say("build", " and ".join(p.name for p in built) + " by nvcc sm_90a, "
        f"in parallel, in {time.perf_counter() - t0:.2f} s")

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
    dets, st, wall = drive_stream(fused, u8, targets, N_SLICE)
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

    # -- 7. rbf kernel vs plain vs float64 --------------------------------
    gs = dict(np.load(SVC_ASSET))
    check(int(gs["scan_seed"]) == int(g["scan_seed"])
          and int(gs["max_targets"]) == int(g["max_targets"]),
          "the SVC golden scans differ from phase 4's")
    t0 = time.perf_counter()
    samples, labels = make_dataset(int(gs["n_samples"]), seed=int(gs["data_seed"]),
                                   hardness=float(gs["hardness"]))
    X = process_samples(samples, scale=True, device=dev)  # (1824, 10010)
    data_s = time.perf_counter() - t0
    sv_index = torch.as_tensor(gs["sv_index"], dtype=torch.int64, device=dev)
    S = X[sv_index]  # the JAX-fitted SVC's support vectors, rebuilt here
    n_sv, F = S.shape
    trng = torch.Generator(device=dev).manual_seed(0)

    def jitter(rows, n_rows):
        pick = torch.randint(0, rows.shape[0], (n_rows,), generator=trng, device=dev)
        noise = 0.02 * torch.randn((n_rows, rows.shape[1]), generator=trng, device=dev)
        return (rows[pick] + noise).clamp(min=0.0).contiguous()

    def uniform(n_rows, f):
        return torch.rand((n_rows, f), generator=trng, device=dev)

    def copies(rows, n_rows):  # exact copies: d2 = 0, the worst cancellation
        pick = torch.randint(0, rows.shape[0], (n_rows,), generator=trng, device=dev)
        return rows[pick].contiguous()

    queries = jitter(X, 4 * BIG)  # the serving shape: B*T queries
    uq, ut, uo = uniform(4 * BIG, F), uniform(X.shape[0], F), uniform(300, F - 1)
    shapes = {  # per shape: (scaled radar rows, uniform [0, 1] rows)
        "serving": ((queries, S), (uq, copies(uq, n_sv))),
        "training": ((X, X), (ut, ut)),
        "ragged": ((X[:37, :50].contiguous(), X[100:123, :50].contiguous()),
                   (uniform(37, 50), uniform(23, 50))),
        "oddF": ((X[:300, :F - 1].contiguous(), jitter(X[:, :F - 1], 200)),
                 (uo, copies(uo, 200))),
    }
    rbf_err = 0.0
    errs = {}  # (shape, kind, gamma) -> kernel error against float64
    lines = []
    for name, pairs in shapes.items():
        worst = []
        for kind, (A, B_) in zip(("real", "unif"), pairs):
            for gamma, ek, er in rbf_errors(A, B_, GAMMAS):
                check(ek <= 2.0 * er + 1e-6,
                      f"rbf kernel error {ek:.3e} > 2x plain {er:.3e} + 1e-6 at "
                      f"{name} {kind} gamma={gamma} {tuple(A.shape)}x{tuple(B_.shape)}")
                rbf_err = max(rbf_err, ek)
                errs[name, kind, gamma] = ek
                worst.append((ek, er))
        lines.append(f"{name} {tuple(pairs[0][0].shape)}x{pairs[0][1].shape[0]}: "
                     f"kernel {max(w[0] for w in worst):.2e} / plain "
                     f"{max(w[1] for w in worst):.2e}")
    for bad in (queries[:, ::2], queries.T):
        try:
            rbf.rbf_gram(bad, bad, 0.01)
        except ValueError:
            continue
        raise AssertionError("rbf_gram took a non-contiguous input")
    say("rbf", f"max |K - K64| over real and uniform rows, gamma {GAMMAS}: "
        + "; ".join(lines) + "; every case within 2x plain + 1e-6; "
        f"non-contiguous input raises; dataset made in {data_s:.1f} s")

    # -- 8. svc fit on the card -------------------------------------------
    jax_svc = svc.SVCModel(
        support_vectors=S,
        dual_coef=torch.as_tensor(gs["dual_coef"], device=dev),
        intercept=torch.as_tensor(gs["intercept"], device=dev),
        n_support=tuple(int(v) for v in gs["n_support"]),
        kernel="rbf", gamma=float(gs["gamma"]),
        probA=torch.as_tensor(gs["probA"], device=dev),
        probB=torch.as_tensor(gs["probB"], device=dev),
    )
    cfg = svc.SVCConfig(C=float(gs["C"]), kernel="rbf", gamma=float(gs["gamma"]),
                        probability=True)
    rbf.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    fitted = svc.svc_fit(X, np.asarray(labels), cfg)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = rbf.KERNEL_LAUNCHES
    check(fit_launches > 0, "svc_fit launched the rbf kernel no time")
    dec_p = svc.decision_function_ovo(fitted, X).cpu().numpy()
    dec_j = svc.decision_function_ovo(jax_svc, X).cpu().numpy()
    excess = float((np.abs(dec_p - dec_j) / (5e-3 + 1e-2 * np.abs(dec_j))).max())
    agree = float((svc.predict(fitted, X) == svc.predict(jax_svc, X)).float().mean())
    check(excess <= 1.0, f"card-fitted decisions off the JAX fit: {excess:.3f}x the bar")
    check(agree >= 0.98, f"card-fitted predictions agree on {agree:.4f} < 0.98")
    d_prob = max(float((fitted.probA - jax_svc.probA).abs().max()),
                 float((fitted.probB - jax_svc.probB).abs().max()))
    say("svc fit", f"svc_fit on {tuple(X.shape)} on the card in {fit_s:.2f} s "
        f"(first call), n_sv {fitted.support_vectors.shape[0]} (JAX {n_sv}); SMO "
        f"iterations per pair {fitted.fit_stats['pairs']}, per Platt sub-fit "
        f"{fitted.fit_stats['platt']}; vs the JAX fit: max |dec diff| "
        f"{float(np.abs(dec_p - dec_j).max()):.2e} ({excess:.3f}x the "
        f"atol 5e-3/rtol 1e-2 bar), predictions agree {agree:.4f}, probA/probB "
        f"delta {d_prob:.2e}; rbf launches {fit_launches}")

    # -- 9. the SVC slice and stream --------------------------------------
    smin = float(gs["min_proba"])
    skw = dict(train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA, model=jax_svc,
               min_proba=smin)
    svc_pred = RadarPredictor(mode="exact", device=dev, **skw)
    svc_fast = RadarPredictor(mode="fast", device=dev, **skw)
    rbf.KERNEL_LAUNCHES = 0  # count the SVC main path's launches only
    res = svc_pred(cubes, xyz, valid)
    check(all(r.device.type == "cuda" for r in res), "svc exact left the card")
    res_fast = svc_fast(cubes, xyz, valid)
    check(all(torch.equal(a, b) for a, b in zip(res, res_fast)),
          "svc fast != svc exact")
    pr, best, proba = (r.cpu().numpy() for r in res)
    check(pr.shape == (N_SLICE, 4) and proba.shape == (N_SLICE, 4, 3), "svc shapes")
    check(np.isfinite(proba).all(), "svc probabilities not finite")
    check((pr[~valid] == -1).all(), "svc padded slots not UNKNOWN")
    ns = int(gs["n_scans"])
    cpu_pred = RadarPredictor(mode="exact", device="cpu",
                              **dict(skw, model=jax_svc.to("cpu")))
    cpu_res = [r.numpy() for r in cpu_pred(cubes[:ns], xyz[:ns], valid[:ns])]
    refs = {"JAX golden": (gs["exact_pred"], gs["exact_best"], gs["exact_proba"]),
            "port on CPU": tuple(cpu_res)}
    svc_golden = []
    for ref_name, (rp, rb, rq) in refs.items():
        ok = margin_ok(rq, rb, smin, SVC_MARGIN)
        delta = float(np.abs(proba[:ns] - rq).max())
        check(delta <= SVC_PROBA_ATOL,
              f"svc vs {ref_name}: proba delta {delta} > {SVC_PROBA_ATOL}")
        check(np.array_equal(pr[:ns][ok], rp[ok]),
              f"svc decisions differ from the {ref_name}")
        svc_golden.append(f"{ref_name} {delta:.2e} ({int((ok & valid[:ns]).sum())} "
                          f"of {int(valid[:ns].sum())} decided)")
    # The decision error a Gram error e (the kernel's, at the serving shape
    # on radar rows and this SVC's gamma) can cause: at most e times the
    # largest L1 norm of a pair's coefficients, ~e times their L2 norm if
    # the entries' errors are independent; a Platt sigmoid moves by at
    # most |probA|/4 times that.
    g_svc = min(GAMMAS, key=lambda v: abs(v - cfg.gamma))
    e_svc = errs["serving", "real", g_svc]
    coef_l1 = float(jax_svc.pair_coef.abs().sum(1).max())
    coef_l2 = float(jax_svc.pair_coef.norm(dim=1).max())
    dets, st, wall = drive_stream(svc_pred, u8, targets, N_STREAM_SVC)
    launches_svc = rbf.KERNEL_LAUNCHES
    check(st["predict_errors"] == 0, f"svc predict_errors {st['predict_errors']}")
    check(st["processed"] == N_STREAM_SVC and len(dets) == N_STREAM_SVC,
          f"svc stream answered {len(dets)} of {N_STREAM_SVC} scans")
    # Stream batches differ from the direct call's, so cuBLAS may sum the
    # pair product in another order: probabilities within 1e-5, labels
    # equal where the direct call's margin exceeds that.
    ok = margin_ok(proba, best, smin, 1e-5)
    for d in dets:
        check(abs(d.proba - best[d.seq, 0]) <= 1e-5, f"svc stream proba at {d.seq}")
        check(not ok[d.seq, 0] or d.label_index == pr[d.seq, 0],
              f"svc stream label differs at scan {d.seq}")
    check(launches_svc > 0, "the SVC path launched the rbf kernel no time")
    say("svc", f"{N_SLICE} scans x 4 slots through the JAX-fitted SVC (n_sv "
        f"{n_sv}) in exact mode on {dev}; fast == exact; padded slots UNKNOWN; "
        f"first {ns} vs " + ", ".join(svc_golden) + f" (decisions where the "
        f"margin > {SVC_MARGIN}, probabilities within {SVC_PROBA_ATOL}; Gram "
        f"error {e_svc:.2e} at gamma {g_svc} bounds a decision's error by "
        f"{e_svc * coef_l1:.2e} (pair-coef L1 {coef_l1:.1f}), ~{e_svc * coef_l2:.2e}"
        f" if independent (L2 {coef_l2:.1f})); stream answered {len(dets)}/"
        f"{N_STREAM_SVC} in {wall:.2f} s, predict_errors 0, mean batch "
        f"{st['mean_batch']:.1f}, detections == direct call; rbf launches in "
        f"this phase: {launches_svc}")

    # -- 10. svc timing -----------------------------------------------------
    rbf_ms = {
        name: interleaved({
            "plain": lambda A=A, B_=B_: rbf.rbf_gram_ref(A, B_, cfg.gamma),
            "kernel": lambda A=A, B_=B_: rbf.rbf_gram(A, B_, cfg.gamma),
        }, inner=3, rounds=5)
        for name, (A, B_) in (("serving", (queries, S)), ("training", (X, X)))
    }
    exact_in = inputs["exact"]
    K = rbf.rbf_gram(queries, S, cfg.gamma)
    dec = svc.decision_function_ovo(jax_svc, queries)
    r = svc._pairwise_prob_matrix(jax_svc, dec)
    parts = interleaved({
        "step": lambda: svc_pred(exact_in, txyz, tvalid),
        "pair": lambda: K @ jax_svc.pair_coef.T + jax_svc.intercept[None, :],
        "couple": lambda: svc._couple_probabilities(r),
        "couple_100": lambda: svc._couple_probabilities(r, check_every=100),
    }, inner=2, rounds=3)
    svc_rate = BIG / (parts["step"] / 1e3)
    gram_ms = rbf_ms["serving"]["kernel"]
    rest = parts["step"] - gram_ms - parts["pair"] - parts["couple"]
    t0 = time.perf_counter()
    svc.svc_fit(X, np.asarray(labels), cfg)
    torch.cuda.synchronize()
    fit_warm_s = time.perf_counter() - t0
    say("svc timing", f"on {smi}: rbf kernel {gram_ms:.4f} ms vs plain "
        f"{rbf_ms['serving']['plain']:.4f} ms at {tuple(queries.shape)}x{n_sv}, "
        f"{rbf_ms['training']['kernel']:.4f} ms vs {rbf_ms['training']['plain']:.4f} "
        f"ms at {tuple(X.shape)}x{X.shape[0]}; SVC exact B={BIG}: {svc_rate:.0f} "
        f"scans/s ({parts['step']:.4f} ms/batch = Gram {gram_ms:.4f} + pair product "
        f"{parts['pair']:.4f} + coupling {parts['couple']:.4f} (without its early "
        f"stop {parts['couple_100']:.4f}) + features and the rest {rest:.4f}); "
        f"svc_fit {fit_warm_s:.2f} s warm")

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
    }, {
        "name": "rbf_gram",
        "route": "cuda",
        "source": RBF_SOURCE,
        "replaces": RBF_REPLACES,
        "launches": launches_svc,
        "max_abs_err": rbf_err,
        "ms": rbf_ms["serving"]["kernel"],
        "plain_ms": rbf_ms["serving"]["plain"],
        "ms_training": rbf_ms["training"]["kernel"],
        "plain_ms_training": rbf_ms["training"]["plain"],
        "fit_launches": fit_launches,
        "svc_scans_per_s": svc_rate,
        "svc_fit_s": fit_warm_s,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
