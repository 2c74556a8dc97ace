"""Drive the PyTorch port's predict, SVC, serving and training paths on one CUDA card.

    python3 chip_smoke.py

Phases, one line of findings each; any failure raises (non-zero exit):

1. device  — a CUDA card is present; its name and power limit.
2. build   — every hand-written kernel (radarml_tpu_torch/ops/csrc/
             i8_score.cu, rbf_gram.cu and native_score.cu) is compiled from
             the checkout's sources by nvcc, one process per source, all
             started together.
3. kernel  — each int8 kernel equals its plain PyTorch version
             (torch.equal) on random int8 cubes. The combo kernel (B1) at
             the default arena, B 1 / 7 / 64 / 133 / 256 / 4096, levels 2
             and 1, each plane masked in turn, a cube view that starts one
             byte into its buffer (the byte-copy path), an odd arena
             (9, 13, 180) and a small one (5, 7, 9). The lookup (B3),
             glookup (B2), sel (B4) and sel3 (B5) kernels at levels 2:
             B 1 / 7 / 64 / 131 / 132 / 133 / 300 / 4096 at the default
             arena (both sides of the batch below which the lookup and
             glookup kernels cut scans into parts), each plane masked in
             turn, an odd arena (9, 13, 180) and a small one (5, 7, 9, one
             slab a scan); at levels 1 (C2 = 3): B 64 / 4096 at the
             default arena and the small one with a masked plane; glookup
             at y-groups 16 / 8 / 31 / 5; sel and sel3 with 4 slots holding
             -1 indices, an index past the end and (sel3) invalid slots,
             sel also with no slot. The bf16 table kernel (B7) against
             its plain float32 version and a float64 oracle on the same
             bf16 cube: B 1 / 7 / 64 / 300 / 4096 at the default arena
             with C 3 and 2, B 7 there with C 1 / 5 / 7 and with a cube
             view 2 bytes off 16-byte alignment (the copy route), B 33 at
             (9, 13, 180) and B 5 at (5, 7, 9), integer and non-integer
             cubes; each table's error against float64 is at most 2x the
             plain version's + 1e-6 x max|oracle|, a second call gives the
             same bits, and 8 classes, over the shared-memory limit at the
             default arena, raise ValueError.
4. slice   — the demo linear model (radarml_tpu_torch/assets/
             demo_linear.npz) scores 512 synthetic scans (4 target slots
             each) through RadarPredictor in exact, fast f32, fast int8,
             fused split under every fused_tail (combo, lookup, glookup,
             sel, sel3), fused single, and pallas with bfloat16 and float32
             streams. Each fused split tail's decisions equal fast int8's
             (probabilities within 1e-6), pallas decisions equal fast
             f32's where its top-2 margin exceeds 1e-4; the first 64 scans
             agree with the JAX package's golden outputs (decisions equal
             where the top-2 margin exceeds 1e-4, probabilities within
             1e-5; fast f32 within 2e-4 of exact, the JAX package's own
             fast-vs-exact bar). The cube indices of the 40,000 targets of
             make_grid_probe() computed on the card are compared with the
             CPU's; each target that differs is printed with both index
             triples and both devices' float32 values before truncation.
5. serving — a StreamingClassifier over the fused combo predictor answers
             every scan of a synthetic source, and ones over the fused sel3
             and the bf16 pallas predictors 128 scans each, with
             predict_errors == 0 and the detections of a direct call.
6. timing  — CUDA events, warm-up, interleaved rounds, medians: each int8
             kernel (B1-B5) and the bf16 table kernel (B7) against its
             plain version and its bound at B=4096 (the demo scans tiled)
             and B=64, with the kernel's own device time from a
             torch.profiler trace beside it (at B=64 the wrapper's host
             dispatch can outlast the kernel), and B7 beside the fast f32
             path's three float32 einsums on the same cube; the lookup and
             glookup kernels' at B 1 / 7 / 64 / 131 / 132 / 133 with their
             plans (and the glookup plan at y-groups 5 / 16 / 31, which is
             one plan); and fused
             (every tail) / fast int8 / fast f32 / pallas (bf16 and f32
             streams) / exact scans per second at B=4096 with inputs
             resident on the card.
7. rbf     — the RBF Gram kernel against its plain version and a float64
             oracle, on scaled features of the SVC dataset (process_samples
             (scale=True) of make_dataset(1824, hardness=1.0)) and on
             uniform [0, 1] rows (against exact copies of themselves where
             the shape allows), at the serving shape (16,384 queries x
             the 1,823 support vectors x 10,010), the training shape
             (1824 x 1824 x 10,010), a ragged one (37 x 23 x 50), an odd
             F (300 x 200 x 10,009, misaligned rows), contiguous views that
             start one row into their buffer (X[1:] against the support
             vectors, and the odd-F pair, whose rows are then only 4-byte
             aligned), F = 1 and F = 7, gamma 0.001 / 0.01 / 0.1: its error
             against float64 is at most 2x the plain float32 version's +
             1e-6. The mean signed error at the serving shape is printed
             beside the plain version's, so that a bias shows. A
             non-contiguous input raises.
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
             shapes (CUDA events over whole calls, the two pack passes
             included, and each of its three kernels' device time from a
             profiler trace), SVC exact scans per second at B=4096 and where
             its time goes, and svc_fit seconds (warm).
11. apps   — the serving slice through its entry points, on the card
             (~30-60 s): the predict app (python -m radarml_tpu_torch.apps.
             predict) over the demo linear model written as a v1 artifact,
             512 synthetic scans in batches of 128 with --mode fused, equal
             to --mode fast --cube_dtype int8 on the same scans (names, and
             probabilities within 1e-6), B1 launched once a batch; 64 scans
             with --derived_targets, whose targets equal derive_targets of
             the same cubes on the CPU (within 1e-4 cm; amplitudes 1e-6
             relative); 128 scans with the JAX-fitted SVC of phase 9 as a v1
             artifact in exact mode, B6 launched, equal to a direct
             RadarPredictor call (1e-6). The serve app with the native C++
             source, --mode fused --max_batch 128 for 5 s (its latency p50 /
             p95, classify rate and mean batch printed beside the card's name
             and power limit), and with 4 synthetic sensors for 2 s; both
             with predict_errors 0. Hot reload: serve with --reload_poll 0.2
             for 5 s while a thread rewrites the artifact with another
             intercept 1 s after the first detection; a swap happens, no
             batch fails, and the last detection equals a direct call of the
             new model on its scan. gRPC, where grpc and the copied
             radar_serving_pb2 import (else one line names the missing
             module and the part is "skipped: <module> not installed"): a
             RadarServingServer over the fused predictor with dynamic
             batching and 8 leader slots answers 64 concurrent Classify calls
             and a 128-scan ClassifyStream like a direct call (1e-6, in
             order), GetStats counts the 192 requests, and B1's launch count
             rises by exactly the server's device batches.
12. train  — the train app (python -m radarml_tpu_torch.apps.train) on
             the card at full width (10,010 features), on make_dataset(
             2280, hardness=1.0) written as a dataset pickle (a training
             split of 1,881 balanced samples): --use_svc with the 30-
             candidate grid and 5 folds (seconds, best parameters and CV
             score, SMO iterations, test accuracy; B6 launched exactly as
             the path implies: the refit's Gram, which its Platt folds
             reuse, and the test-split decisions, 2 when the best kernel
             is rbf, and it must be), B6 timed at those two shapes against
             plain and bound, and the predict app over the artifact in
             exact mode equal to a direct RadarPredictor call (1e-6); the
             35-candidate SGD grid (seconds, epochs per penalty group,
             every walk a CUDA graph replay, ms per epoch of the graph
             against the eager walk for the largest CV group and the
             refit) and the predict app over it with --mode fused (B1
             launched once a batch) equal to --mode fast --cube_dtype int8;
             --online_learn --grid_epochs 20 continuing that artifact (the
             label encoder untouched); --epochs 1 augmentation for each
             family on make_dataset(570); and both families on the dataset
             of radarml_tpu_torch/assets/golden_train.npz (the JAX train
             app's run, xy features) held to its bars (golden_train_check:
             SVC best parameters equal, decisions within atol 5e-4 / rtol
             1e-3, >= 98% equal predictions; fold scores and the SGD
             choice within the JAX package's own one-ulp spread). Where
             matplotlib is missing one line names it and the app writes no
             confusion-matrix figure.

Each kernel's launch count is reset just before its main path and read
just after: the int8 kernels and B7 over phases 4-5 (each fused tail's
kernel on its own tail's path, B7 on the pallas path), the RBF kernel
over phase 9 (and, reported apart, over the fit of phase 8); B1's and B6's
again over phase 11's predict app and B1's over its serve loop, reported
apart as launches_predict_app / launches_serve_app; B6's over phase 12's
SVC train app, as launches_train_app beside the count the path implies,
with its ms at the train path's two shapes (train_shapes). bound_ms is
the larger of the bytes each kernel must move (every input read once,
every output written once) over 3.35 TB/s and the operations its function
needs over the card's peak for their type (int8 1,979 TOP/s; float32 67
TFLOP/s outside the tensor cores; for the RBF Gram the fastest
float32-grade route, three TF32 products per product at 495 TFLOP/s, with
the FP32-FMA bound kept beside it as bound_ms_fp32), computed from this
run's shapes. Every other number in the kernel record was measured in
this run; the times of the seven earlier designs that were replaced
(B1 and B6 by tensor-core kernels, B7 by its bulk-copy ring, B2-B5 by
B1's walk; PERF.md section 6) appear only in the progress lines, labelled
as earlier. No single PyTorch call
computes any of these functions, so library_ms is null (B7's record
carries the fast path's three einsums as fast_f32_ms instead). The line
before last is the kernel record as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from radarml_tpu_torch.apps import common_cli  # noqa: E402
from radarml_tpu_torch.apps import predict as predict_app  # noqa: E402
from radarml_tpu_torch.apps import serve as serve_app  # noqa: E402
from radarml_tpu_torch.apps import train as train_app  # noqa: E402
from radarml_tpu_torch.core.arena import DEFAULT_ARENA, RADAR_MAX, derive_targets  # noqa: E402
from radarml_tpu_torch.data.balance import balance_classes  # noqa: E402
from radarml_tpu_torch.data.labels import LabelEncoder, filter_samples  # noqa: E402
from radarml_tpu_torch.data.split import train_val_test_split  # noqa: E402
from radarml_tpu_torch.data.store import load_datasets, save_dataset  # noqa: E402
from radarml_tpu_torch.drivers import RadarSession, SyntheticRadar  # noqa: E402
from radarml_tpu_torch.data.synthetic import (  # noqa: E402
    make_dataset,
    make_grid_probe,
    make_scan_batch,
)
from radarml_tpu_torch.models import linear, svc  # noqa: E402
from radarml_tpu_torch.models.linear import from_numpy  # noqa: E402
from radarml_tpu_torch.models.pipeline import RadarPredictor, pad_targets  # noqa: E402
from radarml_tpu_torch.ops import _cuda_build  # noqa: E402
from radarml_tpu_torch.ops import i8_score, i8_tails, rbf, score  # noqa: E402
from radarml_tpu_torch.ops.features import FeatureSpec, process_samples  # noqa: E402
from radarml_tpu_torch.serving.stream import StreamConfig, StreamingClassifier  # noqa: E402
from radarml_tpu_torch.train.gridsearch import SGD_PARAM_GRID, parameter_grid  # noqa: E402
from radarml_tpu_torch.utils.profiling import TRACES, kernel_device_ms  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(HERE, "radarml_tpu_torch", "assets", "demo_linear.npz")
SVC_ASSET = os.path.join(HERE, "radarml_tpu_torch", "assets", "demo_svc.npz")
KERNEL_SOURCE = "radarml_tpu_torch/ops/csrc/i8_score.cu"
REPLACES = "radarml_tpu/ops/pallas_i8_score.py:804"
RBF_SOURCE = "radarml_tpu_torch/ops/csrc/rbf_gram.cu"
RBF_REPLACES = "radarml_tpu/ops/pallas_rbf.py:29"
NATIVE_SOURCE = "radarml_tpu_torch/ops/csrc/native_score.cu"
NATIVE_REPLACES = "radarml_tpu/ops/pallas_score.py:78"
# Entry point -> its CUDA kernel's function name, as a profiler trace shows
# it (none is a substring of another).
KERNEL_SYMBOLS = {
    "onepass_tables_combined_i8": "combo_tables_kernel",
    "onepass_tables_i8": "lookup_tables_kernel",
    "onepass_tables_grouped_i8": "grouped_tables_kernel",
    "onepass_tables_sel_i8": "sel_tables_kernel",
    "onepass_scores_i8": "sel3_scores_kernel",
    "native_tables": "native_tables_kernel",
}
RBF_SYMBOLS = {"gram": "rbf_gram_kernel", "pack_x": "rbf_pack_kernel<false>",
               "pack_s": "rbf_pack_kernel<true>"}
# The four other int8 kernels, all in KERNEL_SOURCE: entry point ->
# (fused_tail, TPU kernel body).
TAIL_KERNELS = {
    "onepass_tables_i8": ("lookup", "radarml_tpu/ops/pallas_i8_score.py:376"),
    "onepass_tables_grouped_i8": ("glookup", "radarml_tpu/ops/pallas_i8_score.py:556"),
    "onepass_tables_sel_i8": ("sel", "radarml_tpu/ops/pallas_i8_score.py:250"),
    "onepass_scores_i8": ("sel3", "radarml_tpu/ops/pallas_i8_score.py:998"),
}
HBM_BYTES_S, INT8_OPS_S, FP32_FLOPS_S = 3.35e12, 1.979e15, 67e12  # H100 SXM peaks
TF32_FLOPS_S = 495e12  # dense TF32 on the tensor cores
# The replaced designs' times, for the progress lines only (PERF.md section
# 6; NVIDIA H100 80GB HBM3, 700.00 W): B1 as a __dp4a kernel, device ms at
# B=4096 and B=64; B6 as an FP32-FMA kernel, ms of a call at the serving and
# training shapes. They are not measured here and stay out of the record.
EARLIER_B1_DEVICE_MS = {4096: 0.7997, 64: 0.0319}
EARLIER_B6_MS = {"serving": 21.7467, "training": 2.9960}
# B7 with one slab in flight a block and reductions on every row and slab
# (PERF.md section 6; NVIDIA H100 80GB HBM3, 700.00 W): device ms at B=4096
# and B=64, for the progress lines only, like the two above.
EARLIER_B7_DEVICE_MS = {4096: 1.8097, 64: 0.0787}
# B3 as a z-split and B5 as one block a scan, both on __dp4a (PERF.md
# section 6; NVIDIA H100 80GB HBM3, 700.00 W): device ms at B=4096 and B=64,
# for the progress lines only, like the three above.
EARLIER_B3_DEVICE_MS = {4096: 1.8404, 64: 0.0367}
EARLIER_B5_DEVICE_MS = {4096: 1.1506, 64: 0.0617}
# B2 as a y-split (y-groups of 16) and B4 as one block a scan, both on
# __dp4a (PERF.md section 6; NVIDIA H100 80GB HBM3, 700.00 W): device ms at
# B=4096 and B=64, for the progress lines only, like the five above.
EARLIER_B2_DEVICE_MS = {4096: 0.9269, 64: 0.0344}
EARLIER_B4_DEVICE_MS = {4096: 1.1478, 64: 0.0614}
N_SLICE, BIG, SMALL_B, N_STREAM_SEL3 = 512, 4096, 64, 128
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


def retrace(msg: str) -> None:
    """A profiler trace came back without a kernel and is taken again."""
    say("profiler", msg)


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


def slots(rng, dims, B, T, dev):
    """(B, T, 3) int32 cube indices on `dev`: random cells, the last slot
    of every third scan padded (-1) and one z index past the end."""
    ijk = np.stack([rng.integers(0, n, (B, T)) for n in dims], -1).astype(np.int32)
    ijk[::3, -1] = -1
    ijk[-1, 0, 2] = dims[2]
    return torch.from_numpy(ijk).to(dev)


def tail_fns(name, w, cube, ijk, valid):
    """(kernel call, plain call) of one of the four tail entry points; w
    is GroupedWeights, which every one of them takes."""
    kidx = ijk[..., 2]
    t = i8_tails
    return {
        "onepass_tables_i8": (lambda: t.onepass_tables_i8(cube, w),
                              lambda: t.onepass_tables_i8_ref(cube, w)),
        "onepass_tables_grouped_i8": (lambda: t.onepass_tables_grouped_i8(cube, w),
                                      lambda: t.onepass_tables_grouped_i8_ref(cube, w)),
        "onepass_tables_sel_i8": (lambda: t.onepass_tables_sel_i8(cube, w, kidx),
                                  lambda: t.onepass_tables_sel_i8_ref(cube, w, kidx)),
        "onepass_scores_i8": (lambda: t.onepass_scores_i8(cube, w, ijk, valid),
                              lambda: t.onepass_scores_i8_ref(cube, w, ijk, valid)),
    }[name]


def bound(nbytes: float, ops: float, peak: float):
    """(ms, "bytes" | "operations"): the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int8_bound(name: str, B: int, dims, C2: int, T: int):
    """Bound of an int8 kernel over B scans with T slots, as the pipeline
    calls it (sel3 without a valid mask): cubes and templates read once,
    outputs written once; int8 operations = 2 x the MACs its outputs need
    (the tables in full; for sel3 only the slots' rows)."""
    X, Y, Z = dims
    vox = X * Y * Z
    nbytes = B * vox + C2 * (X * Z + Y * Z + X * Y)
    if name == "onepass_tables_sel_i8":
        nbytes += 4 * B * (C2 * (Y + X) + T * C2 + T)
        macs = B * C2 * (2 * vox + T * X * Y)
    elif name == "onepass_scores_i8":
        nbytes += 4 * B * T * (3 * C2 + 3)
        macs = B * T * C2 * (X * Z + Y * Z + X * Y)
    else:  # the three tables
        nbytes += 4 * B * C2 * (Y + X + Z)
        macs = 3 * B * C2 * vox
    return bound(nbytes, 2 * macs, INT8_OPS_S)


def native_bound(B: int, dims, C: int):
    """Bound of B7 over B scans: the bf16 cubes and float32 templates read
    once, the three float32 tables written once; 2 x the FP32 MACs of
    three full contractions."""
    X, Y, Z = dims
    vox = X * Y * Z
    nbytes = 2 * B * vox + 4 * C * (X * Z + Y * Z + X * Y) + 4 * B * C * (X + Y + Z)
    return bound(nbytes, 2 * 3 * B * C * vox, FP32_FLOPS_S)


def native_errors(cube, tm):
    """Per table: (kernel's, plain version's) max |error| against a float64
    oracle on the same bf16 cube, max |oracle|, max |kernel - plain|, and
    whether a second kernel call gave the same bits."""
    got = score.native_tables(cube, tm)
    torch.cuda.synchronize()
    again = score.native_tables(cube, tm)
    plain = score.native_tables_ref(cube, tm)
    v = cube.double()
    specs = ("cxz,bxyz->bcy", "cyz,bxyz->bcx", "cxy,bxyz->bcz")
    out = []
    for g, a, r, t, spec in zip(got, again, plain, (tm.t_xz, tm.t_yz, tm.t_xy), specs):
        o = torch.einsum(spec, t.double(), v)
        out.append((float((g.double() - o).abs().max()), float((r.double() - o).abs().max()),
                    float(o.abs().max()), float((g - r).abs().max()), torch.equal(g, a)))
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
    """Per gamma: max |K - K64| of the kernel and of the plain version
    against a float64 oracle of the same formula, and both's mean signed
    error K - K64 over the matrix."""
    X64, S64 = X.double(), S.double()
    d2 = ((X64 * X64).sum(1)[:, None] + (S64 * S64).sum(1)[None, :]
          - 2.0 * (X64 @ S64.T)).clamp(min=0.0)
    del X64, S64
    out = []
    for g in gammas:
        k = rbf.rbf_gram(X, S, g)
        torch.cuda.synchronize()
        oracle = torch.exp(-g * d2)
        dk = k.double() - oracle
        dr = rbf.rbf_gram_ref(X, S, g).double() - oracle
        out.append((g, float(dk.abs().max()), float(dr.abs().max()),
                    float(dk.mean()), float(dr.mean())))
    return out


class DetectionLog(logging.Handler):
    """Keeps the (seq, target, label, proba) of every detection that
    `serve --log_detections` logs."""

    def __init__(self):
        super().__init__()
        self.rows = []
        self.on_first = None  # called once, at the first detection

    def emit(self, record):
        if record.msg.startswith("scan %d target %d"):
            self.rows.append(record.args[:4])
            if self.on_first is not None:
                first, self.on_first = self.on_first, None
                first()


def synthetic_scans(n: int, seed: int):
    """The first n scans of `--driver synthetic --driver_seed seed`, as
    the apps see them: (cubes, target lists)."""
    cubes, lists = [], []
    with RadarSession(SyntheticRadar(arena=DEFAULT_ARENA, seed=seed, max_targets=2)) as r:
        for _ in range(n):
            r.trigger()
            lists.append([(t.x, t.y, t.z) for t in r.get_sensor_targets()])
            cubes.append(r.get_raw_image().copy())
    return np.stack(cubes), lists


def phase_apps(dev, smi, g, gs, S, fused, cubes, targets) -> dict:
    """Phase 11: the predict and serve apps, hot reload and the gRPC
    endpoint on the card, through their entry points, with the artifacts
    in a temporary directory. Returns B1's and B6's launch counts, each
    over its own app path, and the gRPC part's outcome."""
    with tempfile.TemporaryDirectory() as d:
        return apps_in(d, dev, smi, g, gs, S, fused, cubes, targets)


def apps_in(d, dev, smi, g, gs, S, fused, cubes, targets) -> dict:
    classes = [str(c) for c in g["classes"]]
    lin, le = os.path.join(d, "linear.pkl"), os.path.join(d, "le.pkl")
    common_cli.save_label_encoder(le, LabelEncoder(tuple(classes)))

    def write_linear(intercept):
        common_cli.save_model(lin, "linear", coef=g["coef"], intercept=intercept,
                              calib_a=g["calib_a"], calib_b=g["calib_b"], classes=classes)

    write_linear(g["intercept"])
    minp = str(float(g["min_proba"]))
    logging.getLogger("radarml_tpu_torch.apps.predict").setLevel(logging.WARNING)
    base = ["--svm_model", lin, "--label_encoder", le, "--min_proba", minp]
    pbase = base + ["--log_file", os.path.join(d, "predict.log"), "--driver", "synthetic",
                    "--driver_seed", "1234"]

    # predict: fused, then fast + int8 on the same scans
    n_scans, batch = 512, 128
    i8_score.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    res_fused = predict_app.main(pbase + ["--mode", "fused", "--batch_scans", str(batch),
                                          "--num_scans", str(n_scans)])
    fused_s = time.perf_counter() - t0
    b1_predict = i8_score.KERNEL_LAUNCHES
    res_fast = predict_app.main(pbase + ["--mode", "fast", "--cube_dtype", "int8",
                                         "--batch_scans", str(batch),
                                         "--num_scans", str(n_scans)])
    check(len(res_fused) >= n_scans and len(res_fused) == len(res_fast),
          f"predict answered {len(res_fused)} / {len(res_fast)} targets")
    check([n for n, _ in res_fused] == [n for n, _ in res_fast],
          "predict fused names != fast int8 names")
    d_pf = float(np.abs(np.array([p for _, p in res_fused])
                        - np.array([p for _, p in res_fast])).max())
    check(d_pf <= 1e-6, f"predict fused vs fast int8 proba delta {d_pf}")
    check(b1_predict == n_scans // batch,
          f"B1 launched {b1_predict} times for {n_scans // batch} fused batches")

    # predict --derived_targets: the targets derived on the card equal
    # derive_targets of the same cubes on the CPU
    derived = []
    real_derive = predict_app.derive_targets

    def spy(cube, arena, num_targets=1):
        out = real_derive(cube, arena, num_targets)
        derived.append((cube.cpu(), [v.cpu() for v in out]))
        return out

    predict_app.derive_targets = spy
    try:
        res_der = predict_app.main(pbase + ["--mode", "fused", "--batch_scans", "64",
                                            "--num_scans", "64", "--derived_targets"])
    finally:
        predict_app.derive_targets = real_derive
    check(len(derived) == 64 and len(res_der) == 64, "derived targets: one a scan")
    d_xyz = d_amp = 0.0
    for cube, got in derived:
        check(got[0].device.type == "cpu" and cube.device.type == "cpu", "copied back")
        want = derive_targets(cube, DEFAULT_ARENA, 1)
        d_xyz = max(d_xyz, max(float((a - b).abs().max()) for a, b in zip(got[:3], want[:3])))
        d_amp = max(d_amp, float(((got[3] - want[3]) / want[3]).abs().max()))
    check(d_xyz <= 1e-4 and d_amp <= 1e-6,
          f"derived targets: card vs CPU xyz {d_xyz} cm, amplitude rel {d_amp}")

    # predict with the SVC artifact (exact mode): B6 launches, and the
    # decisions equal a direct RadarPredictor call on the same scans
    svc_path = os.path.join(d, "svc.pkl")
    common_cli.save_model(
        svc_path, "svc", support_vectors=S, dual_coef=gs["dual_coef"],
        intercept=gs["intercept"], n_support=[int(v) for v in gs["n_support"]],
        kernel="rbf", gamma=float(gs["gamma"]), probA=gs["probA"], probB=gs["probB"],
        classes=classes,
    )
    n_svc, smin = 128, str(float(gs["min_proba"]))
    sargs = ["--svm_model", svc_path, "--label_encoder", le, "--min_proba", smin,
             "--log_file", os.path.join(d, "predict.log"), "--driver", "synthetic",
             "--driver_seed", "1234", "--mode", "exact", "--batch_scans", str(n_svc),
             "--num_scans", str(n_svc)]
    rbf.KERNEL_LAUNCHES = 0
    res_svc = predict_app.main(sargs)
    b6_predict = rbf.KERNEL_LAUNCHES
    check(b6_predict > 0, "the SVC predict path launched the rbf kernel no time")
    model, _ = common_cli.load_model(svc_path, device=dev)
    direct = RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, model, min_proba=float(smin),
                            device=dev)
    scans, lists = synthetic_scans(n_svc, 1234)
    xyz, valid = pad_targets(lists, 4)
    pr, best, _ = (r.cpu().numpy() for r in direct(scans, xyz, valid))
    want = [("Unknown" if pr[b, t] == -1 else classes[int(pr[b, t])], float(best[b, t]))
            for b in range(n_svc) for t in range(4) if valid[b, t]]
    check([n for n, _ in res_svc] == [n for n, _ in want], "SVC predict names != direct")
    d_svc = float(np.abs(np.array([p for _, p in res_svc])
                         - np.array([p for _, p in want])).max())
    check(d_svc <= 1e-6, f"SVC predict proba vs direct call {d_svc}")
    say("apps", f"on {smi}: predict --mode fused {n_scans} scans x batch {batch} in "
        f"{fused_s:.2f} s: {len(res_fused)} targets, names == fast int8, proba delta "
        f"{d_pf:.2e}, B1 launches {b1_predict} == {n_scans // batch} batches; "
        f"--derived_targets 64 scans: card vs CPU derive_targets xyz {d_xyz:.2e} cm, "
        f"amplitude rel {d_amp:.2e}; SVC exact {n_svc} scans: B6 launches {b6_predict}, "
        f"{len(res_svc)} targets == a direct call (proba delta {d_svc:.2e})")

    # serve: the native source, fused, 5 s; then 4 synthetic sensors, 2 s
    sbase = base + ["--mode", "fused", "--max_batch", "128"]
    i8_score.KERNEL_LAUNCHES = 0
    st = serve_app.main(sbase + ["--driver", "native", "--duration", "5"])
    b1_serve = i8_score.KERNEL_LAUNCHES
    check(st["predict_errors"] == 0 and st["processed"] > 0,
          f"serve native: processed {st['processed']}, errors {st['predict_errors']}")
    check(b1_serve > 0, "the serve loop launched B1 no time")
    st4 = serve_app.main(sbase + ["--driver", "synthetic", "--sensors", "4", "--duration", "2"])
    check(st4["predict_errors"] == 0 and st4["processed"] > 0,
          f"serve 4 sensors: processed {st4['processed']}, errors {st4['predict_errors']}")
    say("apps", f"on {smi}: serve --driver native --mode fused --max_batch 128, 5 s: "
        f"processed {st['processed']}, dropped {st['dropped']}, latency_p50_ms "
        f"{st['latency_p50_ms']}, latency_p95_ms {st['latency_p95_ms']}, classify_rate "
        f"{st['classify_rate']} scans/s, ingest_rate {st['ingest_rate']}, mean_batch "
        f"{st['mean_batch']}, predict_errors 0, B1 launches {b1_serve}; 4 synthetic "
        f"sensors, 2 s: processed {st4['processed']}, latency_p50_ms "
        f"{st4['latency_p50_ms']}, latency_p95_ms {st4['latency_p95_ms']}, classify_rate "
        f"{st4['classify_rate']}, mean_batch {st4['mean_batch']}")

    # hot reload: 1 s after the first detection, a thread rewrites the
    # artifact with another intercept; the last detection must follow the
    # new model (its scan is kept as the loop's source returned it)
    # the demo decisions run to hundreds and its Platt slopes are ~1e-3
    new_intercept = g["intercept"] + np.array([3000.0, -3000.0, -3000.0], np.float32)
    grab = DetectionLog()
    rewrite = threading.Timer(1.0, write_linear, args=(new_intercept,))
    grab.on_first = rewrite.start
    served = []  # seq -> (uint8 cube, targets): one sensor, so seq = order
    real_source = serve_app.driver_scan_source

    def keeping_source(driver):
        source = real_source(driver)

        def keep():
            out = source()
            if out is not None:
                served.append((out[0].astype(np.uint8), out[1]))
            return out

        return keep

    serve_log = logging.getLogger("radarml_tpu_torch.apps.serve")
    serve_log.addHandler(grab)
    serve_log.propagate = False  # the detections go to `grab`, not stdout
    serve_app.driver_scan_source = keeping_source
    try:
        st_r = serve_app.main(sbase + ["--driver", "synthetic", "--duration", "5",
                                       "--reload_poll", "0.2", "--log_detections"])
    finally:
        serve_app.driver_scan_source = real_source
        serve_log.removeHandler(grab)
        serve_log.propagate = True
        if rewrite.is_alive():
            rewrite.join()
    check(st_r.get("model_reloads", 0) >= 1, f"model_reloads {st_r.get('model_reloads')}")
    check(st_r["predict_errors"] == 0, f"reload predict_errors {st_r['predict_errors']}")
    seq, tgt, name, proba = grab.rows[-1]
    cube, tl = served[seq]
    xyz, valid = pad_targets([tl], 4)
    outs = {}
    new_model, new_calib = common_cli.load_model(lin, device=dev)
    for key, (m, c) in (("new", (new_model, new_calib)),
                        ("old", from_numpy(g["coef"], g["intercept"], g["calib_a"],
                                           g["calib_b"], device=dev))):
        p_ = RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, m, c, min_proba=float(minp),
                            mode="fused", device=dev)
        pr, best, row = (r.cpu().numpy() for r in p_(cube[None], xyz, valid))
        outs[key] = ("" if pr[0, tgt] == -1 else classes[int(pr[0, tgt])],
                     float(best[0, tgt]), row[0, tgt])
    check((name if name != "Unknown" else "") == outs["new"][0]
          and abs(proba - outs["new"][1]) <= 1e-6,
          f"after the swap scan {seq} target {tgt}: {name} {proba} vs the new model's "
          f"{outs['new']}")
    moved = float(np.abs(outs["new"][2] - outs["old"][2]).max())
    check(moved > 1e-3, f"the new intercept moved the probabilities by {moved} only")
    say("apps", f"hot reload: {st_r['model_reloads']} swap(s), predict_errors 0, "
        f"processed {st_r['processed']}; the last detection (scan {seq} target {tgt}: "
        f"{name} {proba:.6f}) equals a direct call of the new model "
        f"({outs['new'][0] or 'Unknown'} {outs['new'][1]:.6f}; the old model gives "
        f"{outs['old'][0] or 'Unknown'} "
        f"{outs['old'][1]:.6f}, probabilities {moved:.3f} apart)")

    # gRPC: only where grpc and the copied radar_serving_pb2 import
    try:
        import grpc  # noqa: F401
        from radarml_tpu_torch.rpc import radar_serving_pb2  # noqa: F401
    except ImportError as e:
        missing = e.name or "grpc"
        if missing.split(".")[0] not in ("grpc", "google", "radarml_tpu_torch"):
            raise
        grpc_status = f"skipped: {missing} not installed"
        say("apps", f"gRPC part {grpc_status}")
    else:
        grpc_status = grpc_part(smi, fused, cubes, targets)
    return {"b1_predict": b1_predict, "b1_serve": b1_serve, "b6_predict": b6_predict,
            "grpc": grpc_status}


def grpc_part(smi, fused, cubes, targets) -> str:
    """A RadarServingServer over the fused predictor with 8 leader slots:
    64 concurrent unary Classify calls and a 128-scan ClassifyStream each
    equal a direct call; GetStats counts them, and B1's launch count
    rises by exactly the server's device batches (the counter is exact
    under concurrent leaders)."""
    from radarml_tpu_torch.rpc import RadarServingClient, RadarServingServer

    n_unary, n_stream = 64, 128
    u8 = np.rint(cubes[:n_stream]).astype(np.uint8)
    tl = [[(t.x, t.y, t.z)] for t in targets[:n_stream]]
    xyz, valid = pad_targets(tl, 4)
    want = fused(u8, xyz, valid)[2].cpu().numpy()[:, 0]
    classes = ["cat", "dog", "person"]
    server = RadarServingServer(fused, classes=classes, grid_shape=DEFAULT_ARENA.grid_shape,
                                batch_window_ms=1.0, max_concurrent_batches=8).start()
    client = RadarServingClient(f"127.0.0.1:{server.port}", timeout_s=120)
    try:
        i8_score.KERNEL_LAUNCHES = 0
        s0 = client.get_stats()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(n_unary) as pool:
            unary = list(pool.map(lambda s: client.classify(u8[s], tl[s]), range(n_unary)))
        unary_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        streamed = list(client.classify_stream(zip(u8, tl)))
        stream_s = time.perf_counter() - t0
        s1 = client.get_stats()
        launches = i8_score.KERNEL_LAUNCHES
    finally:
        client.close()
        server.stop()
    d = 0.0
    for got in (unary, streamed):
        for s, dets in enumerate(got):
            check(len(dets) == 1, f"gRPC answer {s} has {len(dets)} detections")
            d = max(d, float(np.abs(np.asarray(dets[0].class_probas) - want[s]).max()))
    check(len(streamed) == n_stream, f"ClassifyStream answered {len(streamed)}")
    check(d <= 1e-6, f"gRPC answers vs a direct call: proba delta {d}")
    reqs = s1.classify_requests - s0.classify_requests
    batches = s1.classify_batches - s0.classify_batches
    check(reqs == n_unary + n_stream, f"GetStats counted {reqs} requests")
    check(launches == batches, f"B1 launches {launches} != {batches} device batches")
    say("apps", f"on {smi}: gRPC {n_unary} concurrent Classify in {unary_s:.2f} s and a "
        f"{n_stream}-scan ClassifyStream in {stream_s:.2f} s, in order, == a direct call "
        f"(proba delta {d:.2e}); GetStats {reqs} requests in {batches} device batches; "
        f"B1 launches {launches} == batches (8 leader slots)")
    return "passed"


# -- phase 12: the train app -------------------------------------------------

N_TRAIN, TRAIN_HARDNESS, N_AUG, ONLINE_EPOCHS, N_TRAIN_SCANS = 2280, 1.0, 570, 20, 128
GOLD_ASSET = os.path.join(HERE, "radarml_tpu_torch", "assets", "golden_train.npz")
GOLD_MASK = ["False", "False", "True"]


def rbf_bound(A, B_, peak=TF32_FLOPS_S / 3):
    """Least ms for the Gram of A against B_: its bytes, or its 2 n m F
    float32-grade operations by the fastest route on the card, three TF32
    tensor-core products per product (FP32_FLOPS_S: by FP32 FMAs)."""
    n, F = A.shape
    m = B_.shape[0]
    ms, by = bound(4 * (n * F + m * F + n * m), 2 * n * m * F, peak)
    if by == "operations":
        by = "operations, 3xTF32" if peak != FP32_FLOPS_S else "operations, FP32 FMA"
    return ms, by


def train_args(d, name, *extra):
    return ["--svm_model", os.path.join(d, f"{name}.pkl"),
            "--label_encoder", os.path.join(d, f"{name}_le.pkl"),
            "--svm_cm", os.path.join(d, f"{name}_cm.png"),
            "--log_file", os.path.join(d, f"{name}.log"), *extra]


def write_dataset(path, n, seed, hardness) -> float:
    t0 = time.perf_counter()
    samples, labels = make_dataset(n, seed=seed, hardness=hardness)
    save_dataset(path, samples, labels, append=False)
    return time.perf_counter() - t0


def app_split(path, proj_mask, dev):
    """The train app's flow on the dataset at `path`, by the port's own
    helpers: ((val features, y_val), (test features, y_test), balanced
    training labels); the features on `dev`."""
    data = load_datasets([path])
    samples, labels = filter_samples(data["samples"], data["labels"],
                                     ["person", "dog", "cat"])
    samples = [tuple(np.asarray(p) / RADAR_MAX for p in s) for s in samples]
    _, y = LabelEncoder.fit_transform(labels)
    (_, y_train), (X_val, y_val), (X_test, y_test) = train_val_test_split(
        samples, y, (0.8, 0.1, 0.1), seed=1234)
    y_bal, _ = balance_classes(y_train, np.zeros(len(y_train)))
    mask = common_cli.parse_proj_mask(proj_mask)
    return ((process_samples(X_val, proj_mask=mask, device=dev), np.asarray(y_val)),
            (process_samples(X_test, proj_mask=mask, device=dev), np.asarray(y_test)),
            np.asarray(y_bal))


def predict_matches_direct(d, dev, model_path, le_path, classes, mode, n, batch,
                           min_proba=0.7):
    """The predict app over `n` synthetic scans equals a direct
    RadarPredictor call on the same scans (names, probabilities within
    1e-6); returns (targets answered, proba delta)."""
    res = predict_app.main([
        "--svm_model", model_path, "--label_encoder", le_path,
        "--min_proba", str(min_proba), "--log_file", os.path.join(d, "predict.log"),
        "--driver", "synthetic", "--driver_seed", "1234", "--mode", mode,
        "--batch_scans", str(batch), "--num_scans", str(n)])
    model, calib = common_cli.load_model(model_path, device=dev)
    direct = RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, model, calib,
                            min_proba=min_proba, mode="exact", device=dev)
    scans, lists = synthetic_scans(n, 1234)
    xyz, valid = pad_targets(lists, 4)
    pr, best, _ = (r.cpu().numpy() for r in direct(scans, xyz, valid))
    want = [("Unknown" if pr[b, t] == -1 else classes[int(pr[b, t])], float(best[b, t]))
            for b in range(n) for t in range(4) if valid[b, t]]
    check([m for m, _ in res] == [m for m, _ in want], f"predict {mode} names != direct")
    delta = float(np.abs(np.array([p for _, p in res]) - np.array([p for _, p in want])).max())
    check(delta <= 1e-6, f"predict {mode} proba vs a direct call {delta}")
    return len(res), delta


def walk_epoch_ms(walk, n_epochs: int) -> dict:
    """ms per epoch of a cached SGD walk: graph replays and the eager
    walk, on the same buffers (CUDA events, after one warm epoch each)."""
    perms = np.random.default_rng(0)
    out = {}
    for name, capture in (("graph", True), ("eager", False)):
        walk.epoch(perms.permutation(walk.shape[2]), capture=capture)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_epochs):
            walk.epoch(perms.permutation(walk.shape[2]), capture=capture)
        end.record()
        end.synchronize()
        out[name] = start.elapsed_time(end) / n_epochs
    return out


def golden_train_check(got: dict, g: dict) -> dict:
    """The bars that hold a train run to radarml_tpu_torch/assets/
    golden_train.npz (tests/test_torch_train_golden.py explains them and
    holds the JAX run to them); returns what was measured, fold-score
    deviations in test samples. Raises AssertionError past a bar."""
    out = {}
    size = g["fold_sizes"][None, :].astype(np.float64)
    for fam in ("sgd", "svc"):
        dev = np.abs(got[f"{fam}_scores"] - g[f"{fam}_scores"]) * size
        self_dev = np.abs(g[f"{fam}_ulp_scores"] - g[f"{fam}_scores"][None]) * size[None]
        out[f"{fam}_fold_dev_max"] = float(dev.max())
        out[f"{fam}_fold_dev_mean"] = float(dev.mean())
        out[f"{fam}_jax_ulp_dev_max"] = float(self_dev.max())
        out[f"{fam}_jax_ulp_dev_mean"] = float(self_dev.mean())
        out[f"{fam}_fold_bar"] = out[f"{fam}_jax_ulp_dev_max"] + 1.0
        check(out[f"{fam}_fold_dev_max"] <= out[f"{fam}_fold_bar"] + 1e-9,
              f"{fam} fold scores off the golden: {out}")
    # SVC: equal best parameters; decisions and predictions
    check(json.loads(str(got["svc_params"])) == json.loads(str(g["svc_params"])),
          f"SVC best {got['svc_params']} != golden {g['svc_params']}")
    dj, dt = g["svc_test_dec"], got["svc_test_dec"]
    out["svc_dec_excess"] = float((np.abs(dt - dj) / (5e-4 + 1e-3 * np.abs(dj))).max())
    out["svc_agree"] = float((got["svc_test_pred"] == g["svc_test_pred"]).mean())
    check(out["svc_dec_excess"] <= 1.0 and out["svc_agree"] >= 0.98,
          f"SVC test split off the golden: {out}")
    # SGD: the chosen candidate scores within the JAX runs' spread of the best
    means = np.concatenate([g["sgd_scores"].mean(1)[None], g["sgd_ulp_scores"].mean(2)])
    spread = float((means.max(0) - means.min(0)).max())
    cands = [json.dumps(p, sort_keys=True) for p in parameter_grid(SGD_PARAM_GRID)]
    check(len(cands) == g["sgd_scores"].shape[0], "the golden's SGD grid")
    chosen = cands.index(json.dumps(json.loads(str(got["sgd_params"])), sort_keys=True))
    out["sgd_params_equal"] = chosen == cands.index(
        json.dumps(json.loads(str(g["sgd_params"])), sort_keys=True))
    out["sgd_best_gap"] = float(means[0].max() - means[0][chosen])
    out["sgd_mean_spread"] = spread
    out["sgd_agree"] = float((got["sgd_test_pred"] == g["sgd_test_pred"]).mean())
    out["sgd_agree_bar"] = min(0.98, float(g["sgd_self_agree"]))
    check(out["sgd_best_gap"] <= spread + 1e-12, f"SGD best off the golden: {out}")
    check(out["sgd_agree"] >= out["sgd_agree_bar"], f"SGD test split off the golden: {out}")
    return out


def golden_train_record(d, dev) -> dict:
    """Both families of the train app on the golden asset's dataset, on
    `dev`: the fields golden_train_check compares."""
    g = dict(np.load(GOLD_ASSET))
    path = os.path.join(d, "golden.pickle")
    write_dataset(path, int(g["n_samples"]), int(g["data_seed"]), float(g["hardness"]))
    base = ["--datasets", path, "--proj_mask", *GOLD_MASK, "--folds", str(int(g["folds"]))]
    if dev.type == "cpu":
        base += ["--platform", "cpu"]
    sgd = train_app.main(base + train_args(d, "golden_sgd"))
    svc_out = train_app.main(base + train_args(d, "golden_svc", "--use_svc"))
    _, (F_test, y_test), y_bal = app_split(path, GOLD_MASK, dev)
    model = svc_out["model"]

    def scores(grid):
        return np.asarray([r["split_scores"] for r in grid.cv_results], np.float64)

    check(np.array_equal(y_test, g["y_test"]), "the golden's test split")
    return g, {
        "sgd_params": json.dumps(sgd["grid"].best_params, sort_keys=True),
        "sgd_scores": scores(sgd["grid"]), "sgd_test_pred": sgd["y_pred"],
        "svc_params": json.dumps(svc_out["grid"].best_params, sort_keys=True),
        "svc_scores": scores(svc_out["grid"]),
        "svc_test_dec": svc.decision_function_ovo(model, F_test).cpu().numpy(),
        "svc_test_pred": svc.predict(model, F_test).cpu().numpy(),
        "svc_n_support": np.asarray(model.n_support),
    }


def phase_train(dev, smi) -> dict:
    """Phase 12: the train app on the card, both families, at full width,
    with the artifacts in a temporary directory. Returns B6's numbers on
    the train path."""
    with tempfile.TemporaryDirectory() as d:
        return train_in(d, dev, smi)


def train_in(d, dev, smi) -> dict:
    logging.getLogger("radarml_tpu_torch").setLevel(logging.WARNING)
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    say("train", "matplotlib " + ("imports" if have_mpl else "is not installed: the "
        "train app runs with no confusion-matrix figure"))
    ds = os.path.join(d, "train.pickle")
    data_s = write_dataset(ds, N_TRAIN, 1234, TRAIN_HARDNESS)
    classes = ["cat", "dog", "person"]

    # SVC: the 30-candidate grid, 5 folds; B6 in the refit and the
    # test-split decisions
    rbf.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    out = train_app.main(["--use_svc", "--datasets", ds, *train_args(d, "svc")])
    torch.cuda.synchronize()
    svc_s = time.perf_counter() - t0
    b6_train = rbf.KERNEL_LAUNCHES
    grid, model = out["grid"], out["model"]
    check(model.support_vectors.device.type == "cuda", "the SVC was fitted off the card")
    # the refit's Gram (reused by its Platt folds) and the test decisions
    expected = 2 if model.kernel == "rbf" else 0
    check(b6_train == expected, f"B6 launched {b6_train} times on the train path, "
          f"which implies {expected}")
    check(b6_train > 0, f"the train path's best SVC is {model.kernel}: B6 launched no time")
    _, (F_test, y_test), y_bal = app_split(ds, [True] * 3, dev)
    n_feat = F_test.shape[1]
    check(n_feat == FeatureSpec.for_arena(DEFAULT_ARENA).feature_length == 10010,
          f"{n_feat} features, not the default arena's full width")
    svc_acc = out["metrics"]["accuracy"]
    say("train", f"on {smi}: train --use_svc on make_dataset({N_TRAIN}, hardness "
        f"{TRAIN_HARDNESS}) ({len(y_bal)} balanced training samples x {n_feat} features, "
        f"data made in {data_s:.1f} s): {svc_s:.2f} s; best {grid.best_params}, CV score "
        f"{grid.best_score:.4f}; most SMO iterations in the CV per kernel group "
        f"{grid.smo_iters}, refit per pair {model.fit_stats['pairs']}, per Platt sub-fit "
        f"{model.fit_stats['platt']}; n_sv {model.support_vectors.shape[0]}; B6 launches "
        f"{b6_train} == {expected} (refit Gram + test decisions); test accuracy "
        f"{svc_acc:.4f} on {len(y_test)} scans")
    n_ans, d_svc = predict_matches_direct(
        d, dev, os.path.join(d, "svc.pkl"), os.path.join(d, "svc_le.pkl"), classes,
        "exact", N_TRAIN_SCANS, N_TRAIN_SCANS)
    say("train", f"predict --mode exact over the trained SVC, {N_TRAIN_SCANS} scans: "
        f"{n_ans} targets == a direct RadarPredictor call (proba delta {d_svc:.2e})")

    # B6 at the train path's shapes: the refit Gram and the test decisions
    S = model.support_vectors
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shapes = {"refit": (torch.rand((len(y_bal), n_feat), generator=gen, device=dev),) * 2,
              "test": (F_test.contiguous(), S)}
    b6_ms = {}
    for name, (A, B_) in shapes.items():
        t = interleaved({"plain": lambda A=A, B_=B_: rbf.rbf_gram_ref(A, B_, model.gamma),
                         "kernel": lambda A=A, B_=B_: rbf.rbf_gram(A, B_, model.gamma)},
                        inner=3, rounds=5)
        b6_ms[name] = {"shape": [A.shape[0], B_.shape[0], A.shape[1]], "ms": t["kernel"],
                       "plain_ms": t["plain"], "bound_ms": rbf_bound(A, B_)[0],
                       "bound_by": rbf_bound(A, B_)[1]}
    say("train", "B6 at the train path's shapes on " + smi + ": " + "; ".join(
        f"{k} {v['shape']}: kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, bound "
        f"{v['bound_ms']:.4f} ms ({v['bound_by']})" for k, v in b6_ms.items()))

    # SGD: the 35-candidate grid, 5 folds; the walk replays CUDA graphs
    linear.WALK_LOG.clear()
    t0 = time.perf_counter()
    out = train_app.main(["--datasets", ds, *train_args(d, "sgd")])
    torch.cuda.synchronize()
    sgd_s = time.perf_counter() - t0
    walks = list(linear.WALK_LOG)
    check(all(w["graph"] for w in walks), "an SGD walk ran without its CUDA graph")
    sgd_grid = out["grid"]
    cv = walks[:-1]
    big = max(cv, key=lambda w: w["shape"][1])
    key = (big["penalty"], big["average"], 3, big["shape"], str(dev), True)
    epoch_ms = {"cv": walk_epoch_ms(linear._WALKS[key], 3)}
    refit = walks[-1]
    rkey = (refit["penalty"], refit["average"], 3, refit["shape"], str(dev), True)
    epoch_ms["refit"] = walk_epoch_ms(linear._WALKS[rkey], 3)
    say("train", f"on {smi}: train (SGD) on the same data: {sgd_s:.2f} s; best "
        f"{sgd_grid.best_params}, CV score {sgd_grid.best_score:.4f}; test accuracy "
        f"{out['metrics']['accuracy']:.4f}; epochs run per group "
        + ", ".join(f"{w['penalty']}{' avg' if w['average'] else ''} {w['shape']}: "
                    f"{w['epochs']} in {w['seconds']:.2f} s" for w in walks)
        + f"; ms per epoch, graph replay vs eager walk: largest CV group "
        f"{big['shape']} {epoch_ms['cv']['graph']:.2f} vs {epoch_ms['cv']['eager']:.2f}, "
        f"refit {refit['shape']} {epoch_ms['refit']['graph']:.2f} vs "
        f"{epoch_ms['refit']['eager']:.2f}")
    lin_path, lin_le = os.path.join(d, "sgd.pkl"), os.path.join(d, "sgd_le.pkl")
    n_fused, batch = 256, 128
    i8_score.KERNEL_LAUNCHES = 0
    fused_res = predict_app.main([
        "--svm_model", lin_path, "--label_encoder", lin_le, "--log_file",
        os.path.join(d, "predict.log"), "--driver", "synthetic", "--driver_seed", "1234",
        "--mode", "fused", "--batch_scans", str(batch), "--num_scans", str(n_fused)])
    b1 = i8_score.KERNEL_LAUNCHES
    fast_res = predict_app.main([
        "--svm_model", lin_path, "--label_encoder", lin_le, "--log_file",
        os.path.join(d, "predict.log"), "--driver", "synthetic", "--driver_seed", "1234",
        "--mode", "fast", "--cube_dtype", "int8", "--batch_scans", str(batch),
        "--num_scans", str(n_fused)])
    check([n for n, _ in fused_res] == [n for n, _ in fast_res],
          "trained SGD: predict fused names != fast int8")
    d_ff = float(np.abs(np.array([p for _, p in fused_res])
                        - np.array([p for _, p in fast_res])).max())
    check(d_ff <= 1e-6, f"trained SGD: fused vs fast int8 proba delta {d_ff}")
    check(b1 == n_fused // batch, f"B1 launched {b1} times for {n_fused // batch} batches")
    say("train", f"predict --mode fused over the trained SGD model, {n_fused} scans: "
        f"{len(fused_res)} targets, names == --mode fast --cube_dtype int8, proba delta "
        f"{d_ff:.2e}, B1 launches {b1}")

    # --online_learn continues that artifact (ONLINE_EPOCHS epochs)
    before = common_cli.load_model_meta(lin_path)
    le_mtime = os.path.getmtime(lin_le)
    linear.WALK_LOG.clear()
    t0 = time.perf_counter()
    out = train_app.main(["--online_learn", "--datasets", ds, "--grid_epochs",
                          str(ONLINE_EPOCHS), *train_args(d, "sgd")])
    online_s = time.perf_counter() - t0
    after = common_cli.load_model_meta(lin_path)
    check(os.path.getmtime(lin_le) == le_mtime, "online learning rewrote the label encoder")
    check(after["sgd_cfg"] == before["sgd_cfg"], "online learning changed the config")
    walk = linear.WALK_LOG[-1]
    check(walk["graph"], "the online walk ran without its CUDA graph")
    check(walk["epochs"] == ONLINE_EPOCHS and walk["shape"][2] == len(y_bal),
          f"online learning walked {walk['epochs']} epochs of {walk['shape'][2]} samples")
    # t counts the steps in float32 from a fractional t0, so each +1 rounds
    steps = after["sgd_t"] - before["sgd_t"]
    check(abs(steps - ONLINE_EPOCHS * len(y_bal)) <= 1e-3 * ONLINE_EPOCHS * len(y_bal),
          f"online learning moved t by {steps}, not {ONLINE_EPOCHS} x {len(y_bal)}")
    say("train", f"--online_learn --grid_epochs {ONLINE_EPOCHS}: {online_s:.2f} s, "
        f"{int(steps)} steps from t {before['sgd_t']:.0f}, test accuracy "
        f"{out['metrics']['accuracy']:.4f}; the label encoder untouched")

    # --epochs 1: augmentation once for each family, on a smaller dataset
    ds_aug = os.path.join(d, "aug.pickle")
    write_dataset(ds_aug, N_AUG, 1234, TRAIN_HARDNESS)
    aug = {}
    for fam in ("sgd", "svc"):
        t0 = time.perf_counter()
        out = train_app.main(["--epochs", "1", "--datasets", ds_aug,
                              *train_args(d, f"aug_{fam}"), *(["--use_svc"] if fam == "svc" else [])])
        aug[fam] = (time.perf_counter() - t0, out["metrics"]["accuracy"])
        check(out["kind"] == ("svc" if fam == "svc" else "linear"), f"augment {fam}")
    say("train", f"--epochs 1 on make_dataset({N_AUG}): SGD {aug['sgd'][0]:.2f} s "
        f"(test accuracy {aug['sgd'][1]:.4f}), SVC {aug['svc'][0]:.2f} s (test accuracy "
        f"{aug['svc'][1]:.4f})")

    # held against the JAX package's golden run, without importing it
    t0 = time.perf_counter()
    g, got = golden_train_record(d, dev)
    measured = golden_train_check(got, g)
    say("train", f"golden (radarml_tpu_torch/assets/golden_train.npz, make_dataset("
        f"{int(g['n_samples'])}, hardness {float(g['hardness'])}), xy features) in "
        f"{time.perf_counter() - t0:.1f} s: SVC best {got['svc_params']} == golden; SGD "
        f"best {got['sgd_params']} (golden {str(g['sgd_params'])}); "
        + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in measured.items()))
    return {"launches_train_app": b6_train, "expected_train_app": expected,
            "shapes": b6_ms}


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
    sources = ("i8_score", "rbf_gram", "native_score")
    for name in sources:
        stale = _cuda_build.library_path(name)
        if stale.exists():
            stale.unlink()  # always compile this checkout's sources
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        built = list(pool.map(_cuda_build.build, sources))
    i8_score._library()
    rbf._library()
    score._library()
    say("build", ", ".join(p.name for p in built) + " by nvcc sm_90a, "
        f"in parallel, in {time.perf_counter() - t0:.2f} s")

    # -- 3. kernel vs plain -----------------------------------------------
    dims = DEFAULT_ARENA.grid_shape
    rng = np.random.default_rng(0)
    max_err = 0
    cases = [(dims, 256, 2, None), (dims, 256, 1, None), (dims, 256, 2, 1),
             (dims, BIG, 2, None), (dims, BIG, 1, None)]
    cases += ([(dims, B, 2, None) for B in (1, 7, SMALL_B, 133)]
              + [(dims, SMALL_B, 2, m) for m in (0, 2)]
              + [((9, 13, 180), 33, 2, None), ((5, 7, 9), 5, 2, 1), ((5, 7, 9), 5, 1, 0),
                 (dims, 7, 2, "offset")])
    for cdims, B, levels, masked in cases:
        offset = masked == "offset"  # a contiguous view one byte into its buffer
        masked = None if offset else masked
        w = i8_score.build_combined_weights(
            random_quant(rng, cdims, levels, masked), cdims, levels=levels, device=dev
        )
        n_vox = B * cdims[0] * cdims[1] * cdims[2]
        flat = torch.from_numpy(rng.integers(-128, 128, n_vox + 1, dtype=np.int8)).to(dev)
        cube = flat[int(offset):n_vox + int(offset)].view((B,) + cdims)
        check(cube.is_contiguous() and (cube.data_ptr() % 16 != 0) == offset,
              "the offset case's cube alignment")
        got = i8_score.onepass_tables_combined_i8(cube, w)
        torch.cuda.synchronize()
        want = i8_score.onepass_tables_combined_i8_ref(cube, w)
        for g, r in zip(got, want):
            check(g.shape == r.shape and g.dtype == torch.int32, "table shape/dtype")
            max_err = max(max_err, int((g.long() - r.long()).abs().max()))
            check(torch.equal(g, r), f"kernel != plain at dims={cdims} B={B} "
                  f"levels={levels} masked={masked} offset={offset}")
        if masked is not None:
            check(not got[masked].any(), "masked plane gave a non-zero table")
    w = i8_score.build_combined_weights(random_quant(rng, dims, 2), dims, device=dev)
    say("kernel", f"combo tables equal the plain version in {len(cases)} cases "
        f"(B 1/7/64/133/256/4096, levels 2/1, each plane masked, a view one byte into "
        f"its buffer, dims (9, 13, 180) and (5, 7, 9)); max_abs_err {max_err}; "
        f"x-slab {i8_score.slab_width(w)} of {dims[0]}")
    tail_err = dict.fromkeys(TAIL_KERNELS, 0)
    n_tail = 0
    tail_cases = ([(dims, B, None, 2) for B in (1, 7, SMALL_B, 131, 132, 133, 300, BIG)]
                  + [(dims, SMALL_B, m, 2) for m in (0, 1, 2)]
                  + [((9, 13, 180), 33, None, 2), ((5, 7, 9), 5, 1, 2)]
                  + [(dims, SMALL_B, None, 1), (dims, BIG, None, 1), ((5, 7, 9), 5, 0, 1)])
    for tdims, B, masked, levels in tail_cases:
        quant = random_quant(rng, tdims, levels, masked)
        cube = torch.from_numpy(rng.integers(-128, 128, (B,) + tdims, dtype=np.int8)).to(dev)
        ijk = slots(rng, tdims, B, 4, dev)
        valid = torch.from_numpy(rng.random((B, 4)) < 0.75).to(dev)
        runs = []
        for yg in (16, 8, 31, 5):
            w = i8_tails.build_grouped_weights(quant, tdims, min(yg, tdims[1]),
                                               levels=levels, device=dev)
            runs.append(("onepass_tables_grouped_i8",
                         tail_fns("onepass_tables_grouped_i8", w, cube, ijk, None)))
        for name, v in (("onepass_tables_i8", None), ("onepass_tables_sel_i8", None),
                        ("onepass_scores_i8", None), ("onepass_scores_i8", valid)):
            runs.append((name, tail_fns(name, w, cube, ijk, v)))
        runs.append(("onepass_tables_sel_i8",  # no slot: only the tables leave
                     tail_fns("onepass_tables_sel_i8", w, cube, ijk[:, :0], None)))
        for name, (kernel, plain) in runs:
            got = kernel()
            torch.cuda.synchronize()
            for g, r in zip(got, plain()):
                check(g.shape == r.shape and g.dtype == torch.int32, f"{name} shape/dtype")
                if g.numel():  # sel's reads are empty with no slot
                    tail_err[name] = max(tail_err[name], int((g.long() - r.long()).abs().max()))
                check(torch.equal(g, r), f"{name} != plain at dims={tdims} B={B} "
                      f"masked={masked} levels={levels}")
            if masked is not None:  # each output reads one plane's table
                check(not got[masked].any(), f"{name}: masked plane gave non-zero")
            n_tail += 1
    say("kernel", f"lookup, glookup, sel and sel3 equal their plain versions in "
        f"{n_tail} runs ({len(tail_cases)} cases: B 1/7/64/131/132/133/300/4096, each "
        f"plane masked, "
        f"dims (9, 13, 180) and (5, 7, 9), levels 2 and (C2 = 3) 1; y-groups "
        f"16/8/31/5; 4 slots with -1, past-the-end and invalid ones, and sel with "
        f"none); max_abs_err {tail_err}")
    native_err = native_f64 = 0.0
    # B 300: several scans a block, so the slab ring wraps; C 5 and 7 (the
    # most that fit at the default arena); "offset": a contiguous view 2
    # bytes off 16-byte alignment, which takes the copy route.
    native_cases = ([(dims, B, C, kind) for B in (1, 7, SMALL_B, 300, BIG)
                     for C in (3, 2) for kind in ("int", "float")]
                    + [(dims, 7, C, "float") for C in (1, 5, 7)]
                    + [(dims, 7, 3, "offset")]
                    + [(d, B, C, kind) for d, B in (((9, 13, 180), 33), ((5, 7, 9), 5))
                       for C in (3, 2) for kind in ("int", "float")])
    worst = (-1.0, "")
    cgen = torch.Generator(device=dev).manual_seed(7)
    for ndims, B, C, kind in native_cases:
        tm = score.native_templates(
            *[rng.normal(size=(C,) + s).astype(np.float32) * 0.01
              for s in ((ndims[0], ndims[2]), (ndims[1], ndims[2]), (ndims[0], ndims[1]))],
            device=dev)
        raw = torch.rand((B,) + ndims, generator=cgen, device=dev) * 255
        cube = (raw.round() if kind == "int" else raw).to(torch.bfloat16)
        if kind == "offset":
            flat = torch.zeros(cube.numel() + 1, dtype=torch.bfloat16, device=dev)
            cube = flat[1:].view(cube.shape).copy_(cube)
            check(cube.is_contiguous() and cube.data_ptr() % 16 == 2,
                  "the offset case's cube alignment")
        for t, (ek, er, omax, d, same) in zip(("m1", "m2", "m3"), native_errors(cube, tm)):
            where = f"B7 {t} at dims={ndims} B={B} C={C} {kind} cube"
            check(same, f"{where}: a second call gave other bits")
            check(ek <= 2.0 * er + 1e-6 * omax,
                  f"{where}: error vs float64 {ek:.3e} > 2x plain {er:.3e} + 1e-6 x {omax:.3e}")
            native_err, native_f64 = max(native_err, d), max(native_f64, ek)
            worst = max(worst, (ek / max(er, 1e-30), where))
    C_over = 8
    tm6 = score.native_templates(
        *[torch.zeros((C_over,) + s) for s in ((dims[0], dims[2]), (dims[1], dims[2]),
                                               (dims[0], dims[1]))], device=dev)
    try:
        score.native_tables(torch.zeros((1,) + dims, dtype=torch.bfloat16, device=dev), tm6)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"B7 took {C_over} classes over its shared-memory limit")
    say("kernel", f"B7 tables within 2x the plain float32 version's float64 error "
        f"(+1e-6 x max|oracle|) in {len(native_cases)} cases (B 1/7/64/300/4096 at "
        f"{dims} with C 3/2, B 7 with C 1/5/7 and a view 2 bytes off alignment, "
        f"(9, 13, 180) B 33, (5, 7, 9) B 5; integer and non-integer cubes), the same "
        f"bits on a second call; max |kernel - plain| {native_err:.3e}, "
        f"max |kernel - float64| {native_f64:.3e}, largest ratio to plain's error "
        f"{worst[0]:.2f} ({worst[1]}); {C_over} classes refused: {refused}")

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
        "pallas": RadarPredictor(mode="pallas", cube_dtype="bfloat16", **kw),
        "pallas_f32": RadarPredictor(mode="pallas", **kw),
    }
    for name, (tail, _) in TAIL_KERNELS.items():
        preds[f"fused_{tail}"] = RadarPredictor(mode="fused", fused_tail=tail, **kw)
    i8_score.KERNEL_LAUNCHES = 0  # count the main path's launches only
    for name in i8_tails.LAUNCHES:
        i8_tails.LAUNCHES[name] = 0
    score.KERNEL_LAUNCHES = 0
    out = {}
    for name, p in preds.items():
        if p.mode == "fused":
            src = p.pack_host(cubes.astype(np.uint8))
        elif p.mode == "pallas":
            src = p.encode_host(cubes)  # the stream's own dtype, from the host
        else:
            src = cubes
        res = p(src, xyz, valid)
        check(all(r.device.type == "cuda" for r in res), f"{name} left the card")
        out[name] = [r.cpu().numpy() for r in res]
    for name, (pr, best, proba) in out.items():
        check(pr.shape == (N_SLICE, 4) and proba.shape == (N_SLICE, 4, 3),
              f"{name} shapes")
        check(np.isfinite(proba).all() and np.isfinite(best).all(), f"{name} finite")
        check((pr[~valid] == -1).all(), f"{name} padded slots not UNKNOWN")
    split = ["fused"] + [f"fused_{tail}" for tail, _ in TAIL_KERNELS.values()]
    d_fused_fast = {}
    for name in split:
        check(np.array_equal(out[name][0], out["fast_i8"][0]),
              f"{name} split decisions != fast int8 decisions")
        d_fused_fast[name] = float(np.abs(out[name][2] - out["fast_i8"][2]).max())
        check(d_fused_fast[name] <= 1e-6,
              f"{name} vs fast int8 proba delta {d_fused_fast[name]}")
    ok_fast = margin_ok(out["fast"][2], out["fast"][1], min_proba)
    d_pallas_fast = {}
    for name in ("pallas", "pallas_f32"):
        check(np.array_equal(out[name][0][ok_fast], out["fast"][0][ok_fast]),
              f"{name} decisions != fast f32 decisions where the margin > 1e-4")
        d_pallas_fast[name] = float(np.abs(out[name][2] - out["fast"][2]).max())
    n = int(g["n_scans"])
    golden = []
    for name, ref, atol in (("exact", "exact", 1e-5), *((f, "fused", 1e-5) for f in split),
                            ("fast_i8", "fused", 1e-5), ("fast", "exact", 2e-4),
                            ("pallas", "pallas", 1e-5), ("pallas_f32", "pallas", 1e-5)):
        pr, _, proba = (a[:n] for a in out[name])
        ok = margin_ok(g[f"{ref}_proba"], g[f"{ref}_best"], min_proba)
        delta = float(np.abs(proba - g[f"{ref}_proba"]).max())
        check(delta <= atol, f"{name} vs JAX {ref} golden: proba delta {delta} > {atol}")
        check(np.array_equal(pr[ok], g[f"{ref}_pred"][ok]),
              f"{name} decisions differ from the JAX {ref} golden")
        golden.append(f"{name}~{ref} {delta:.2e} "
                      f"({int((ok & valid[:n]).sum())} of {int(valid[:n].sum())} decided)")
    d_single = float(np.abs(out["fused_single"][2] - out["fused"][2]).max())
    say("slice", f"{N_SLICE} scans x 4 slots through exact/fast/fast_i8/fused "
        f"(combo, lookup, glookup, sel, sel3)/fused_single/pallas (bf16, f32) on "
        f"{dev}; every fused split tail == fast_i8 decisions, proba delta "
        + ", ".join(f"{k} {v:.2e}" for k, v in d_fused_fast.items())
        + f"; pallas == fast decisions on {int(ok_fast.sum())} of {ok_fast.size} "
        f"slots with margin > 1e-4, proba delta "
        + ", ".join(f"{k} {v:.2e}" for k, v in d_pallas_fast.items())
        + f"; golden (first {n}): " + ", ".join(golden)
        + f"; fused_single vs split proba delta {d_single:.2e}")
    # float32 trig on the card may round differently from the CPU: count
    # the truncated cube indices that differ and print each such target
    # (reported, not fatal; tests/test_torch_arena_card.py pins them).
    pts = torch.from_numpy(make_grid_probe())
    on_cpu = torch.stack(DEFAULT_ARENA.clamped_matrix_indices(*pts.T), -1)
    on_dev = torch.stack(DEFAULT_ARENA.clamped_matrix_indices(*pts.to(dev).T), -1).cpu()
    v_cpu = torch.stack(DEFAULT_ARENA.index_values(*pts.T), -1)
    v_dev = torch.stack(DEFAULT_ARENA.index_values(*pts.to(dev).T), -1).cpu()
    differ = on_cpu != on_dev
    for t in torch.nonzero(differ.any(-1)).flatten().tolist()[:50]:
        say("indices", f"target {t} at xyz {pts[t].tolist()} cm: CPU {on_cpu[t].tolist()}, "
            f"card {on_dev[t].tolist()}; float32 values before truncation CPU "
            f"{[f'{x:.7f}' for x in v_cpu[t].tolist()]}, card "
            f"{[f'{x:.7f}' for x in v_dev[t].tolist()]}")
    say("indices", f"{len(pts)} targets of make_grid_probe() (grid nodes and jittered): "
        f"{int(differ.sum())} of {differ.numel()} cube indices differ between {dev} and "
        f"the CPU")

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
    sel3 = preds["fused_sel3"]
    dets3, st3, wall3 = drive_stream(sel3, u8, targets, N_STREAM_SEL3)
    tail_launches = dict(i8_tails.LAUNCHES)
    check(st3["predict_errors"] == 0, f"sel3 predict_errors {st3['predict_errors']}")
    check(st3["processed"] == N_STREAM_SEL3 and len(dets3) == N_STREAM_SEL3,
          f"sel3 stream answered {len(dets3)} of {N_STREAM_SEL3} scans")
    pr3, best3, _ = out["fused_sel3"]
    for d in dets3:
        check(d.label_index == pr3[d.seq, 0], f"sel3 stream label differs at {d.seq}")
        check(abs(d.proba - best3[d.seq, 0]) <= 1e-6, f"sel3 stream proba at {d.seq}")
    for name, (tail, _) in TAIL_KERNELS.items():
        check(tail_launches[name] > 0, f"the {tail} path launched {name} no time")
    detsp, stp, wallp = drive_stream(preds["pallas"], u8, targets, N_STREAM_SEL3)
    native_launches = score.KERNEL_LAUNCHES
    check(stp["predict_errors"] == 0, f"pallas predict_errors {stp['predict_errors']}")
    check(stp["processed"] == N_STREAM_SEL3 and len(detsp) == N_STREAM_SEL3,
          f"pallas stream answered {len(detsp)} of {N_STREAM_SEL3} scans")
    prp, bestp, _ = out["pallas"]
    for d in detsp:
        check(d.label_index == prp[d.seq, 0], f"pallas stream label differs at {d.seq}")
        check(abs(d.proba - bestp[d.seq, 0]) <= 1e-6, f"pallas stream proba at {d.seq}")
    check(native_launches > 0, "the pallas path launched the B7 kernel no time")
    say("serving", f"combo stream answered {len(dets)}/{N_SLICE} scans in {wall:.2f} s, "
        f"predict_errors 0, dropped {st['dropped']}, mean batch "
        f"{st['mean_batch']:.1f}; sel3 stream {len(dets3)}/{N_STREAM_SEL3} in "
        f"{wall3:.2f} s, predict_errors 0, mean batch {st3['mean_batch']:.1f}; "
        f"pallas (bf16) stream {len(detsp)}/{N_STREAM_SEL3} in {wallp:.2f} s, "
        f"predict_errors 0, mean batch {stp['mean_batch']:.1f}; "
        f"detections == direct call; launches in phases 4-5: combo {launches}, "
        + ", ".join(f"{k} {v}" for k, v in tail_launches.items())
        + f", native_tables {native_launches}")

    # -- 6. timing --------------------------------------------------------
    tiled = np.tile(cubes, (BIG // N_SLICE, 1, 1, 1))
    txyz = torch.from_numpy(np.tile(xyz, (BIG // N_SLICE, 1, 1))).to(dev)
    tvalid = torch.from_numpy(np.tile(valid, (BIG // N_SLICE, 1))).to(dev)
    packed = fused.pack_host(tiled.astype(np.uint8)).to(dev)
    w_single = i8_score.build_combined_weights(
        preds["fused_single"]._quantized_split_templates(1), dims, levels=1, device=dev)
    kernel_single = interleaved({
        "plain": lambda: i8_score.onepass_tables_combined_i8_ref(packed, w_single),
        "kernel": lambda: i8_score.onepass_tables_combined_i8(packed, w_single),
    }, inner=5, rounds=5)
    # Every int8 kernel at levels 2 on the demo model's templates and the
    # tiled demo scans' clamped target indices, at B=4096 and B=64.
    quant2 = preds["fused"]._quantized_split_templates(2)
    w_combo = i8_score.build_combined_weights(quant2, dims, levels=2, device=dev)
    w_tails = i8_tails.build_grouped_weights(quant2, dims, 16, device=dev)
    tijk = torch.stack(fused._indices(txyz), -1).to(torch.int32)
    int8_ms = {}
    for B, inner in ((BIG, 5), (SMALL_B, 50)):
        cube_b, ijk_b = packed[:B], tijk[:B]
        fns = {"onepass_tables_combined_i8": (
            lambda c=cube_b: i8_score.onepass_tables_combined_i8(c, w_combo),
            lambda c=cube_b: i8_score.onepass_tables_combined_i8_ref(c, w_combo))}
        for name in TAIL_KERNELS:
            fns[name] = tail_fns(name, w_tails, cube_b, ijk_b, None)
        ms = interleaved({(name, kind): f for name, pair in fns.items()
                          for kind, f in zip(("kernel", "plain"), pair)},
                         inner=inner, rounds=5)
        dev_ms = kernel_device_ms({name: pair[0] for name, pair in fns.items()},
                                  {name: KERNEL_SYMBOLS[name] for name in fns}, reps=20,
                                  log=retrace)
        int8_ms[B] = {name: {kind: ms[name, kind] for kind in ("kernel", "plain")}
                      | {"device": dev_ms[name]}
                      | dict(zip(("bound", "bound_by"), int8_bound(name, B, dims, 6, 4)))
                      for name in fns}
    # B7 on the demo model's float32 templates and the tiled demo scans in
    # bf16, beside the fast f32 path's three einsums on the float32 cube.
    f32_all = torch.from_numpy(tiled.astype(np.float32)).to(dev)
    bf16_all = f32_all.to(torch.bfloat16)
    tm_demo = score.native_templates(*preds["pallas"]._split_templates(), device=dev)
    specs = ("cxz,bxyz->bcy", "cyz,bxyz->bcx", "cxy,bxyz->bcz")
    fast_t = (tm_demo.t_xz, tm_demo.t_yz, tm_demo.t_xy)
    native_ms = {}
    for B, inner in ((BIG, 5), (SMALL_B, 50)):
        cb, cf = bf16_all[:B], f32_all[:B]
        ms = interleaved({
            "kernel": lambda c=cb: score.native_tables(c, tm_demo),
            "plain": lambda c=cb: score.native_tables_ref(c, tm_demo),
            "fast_f32": lambda c=cf: [torch.einsum(sp, t, c) for sp, t in zip(specs, fast_t)],
        }, inner=inner, rounds=5)
        ms["device"] = kernel_device_ms(
            {"native_tables": lambda c=cb: score.native_tables(c, tm_demo)},
            {"native_tables": KERNEL_SYMBOLS["native_tables"]}, reps=20,
            log=retrace)["native_tables"]
        ms["bound"], ms["bound_by"] = native_bound(B, dims, tm_demo.dims[3])
        native_ms[B] = ms
    # The lookup and glookup kernels on both sides of the batch below which
    # they cut scans, with the plan each launched.
    for kernel, name, fn in (
            ("lookup", "onepass_tables_i8", i8_tails.onepass_tables_i8),
            ("grouped", "onepass_tables_grouped_i8", i8_tails.onepass_tables_grouped_i8)):
        by_batch = {
            B: kernel_device_ms({"k": lambda c=packed[:B], fn=fn: fn(c, w_tails)},
                                {"k": KERNEL_SYMBOLS[name]}, reps=20, log=retrace)["k"]
            for B in (1, 7, 131, 132, 133)}
        by_batch[SMALL_B] = int8_ms[SMALL_B][name]["device"]
        say("timing", f"{name} device ms by batch, with its plan's parts P and slab width "
            "XS: " + ", ".join(
                "B={} (P {}, XS {}) {:.4f}".format(
                    B, *i8_tails.lookup_plan_on_card(B, w_tails, kernel), v)
                for B, v in sorted(by_batch.items())))
    # The y-group is the JAX kernel's tiling: the glookup plan ignores it.
    yg_plans = {}
    for yg in (5, 16, 31):
        wy = i8_tails.build_grouped_weights(quant2, dims, yg, device=dev)
        yg_plans[yg] = [i8_tails.lookup_plan_on_card(B, wy, "grouped")
                        for B in (1, 7, SMALL_B, 131, 132, 133, BIG)]
    check(len({tuple(p) for p in yg_plans.values()}) == 1,
          f"the glookup plan depends on the y-group: {yg_plans}")
    say("timing", "glookup plans (P, XS) at B 1/7/64/131/132/133/4096 for y-groups 5 / 16 / "
        f"31: one plan, {yg_plans[16]}")
    inputs = {name: packed for name in split + ["fast_i8"]}
    inputs |= {"exact": f32_all, "fast": f32_all, "pallas": bf16_all, "pallas_f32": f32_all}
    step_ms = interleaved(
        {k: (lambda k=k: preds[k](inputs[k], txyz, tvalid)) for k in inputs},
        inner=3, rounds=5,
    )
    rates = {k: BIG / (v / 1e3) for k, v in step_ms.items()}
    for B in (BIG, SMALL_B):
        say("timing", f"B={B} on {smi}: " + "; ".join(
            f"{name} {t['kernel']:.4f} ms (device {t['device']}) vs plain "
            f"{t['plain']:.4f} ms, bound {t['bound']:.4f} ms ({t['bound_by']})"
            for name, t in int8_ms[B].items())
            + f"; earlier designs (PERF.md section 6, not measured here): "
            f"onepass_tables_combined_i8 on __dp4a device {EARLIER_B1_DEVICE_MS[B]} ms, "
            f"onepass_tables_i8 as a z-split {EARLIER_B3_DEVICE_MS[B]} ms, "
            f"onepass_scores_i8 on __dp4a {EARLIER_B5_DEVICE_MS[B]} ms, "
            f"onepass_tables_grouped_i8 as a y-split {EARLIER_B2_DEVICE_MS[B]} ms, "
            f"onepass_tables_sel_i8 on __dp4a {EARLIER_B4_DEVICE_MS[B]} ms")
    for B in (BIG, SMALL_B):
        t = native_ms[B]
        say("timing", f"B={B} on {smi}: B7 native_tables {t['kernel']:.4f} ms (device "
            f"{t['device']}) vs plain {t['plain']:.4f} ms and the fast f32 einsums "
            f"{t['fast_f32']:.4f} ms, bound {t['bound']:.4f} ms ({t['bound_by']}); "
            f"the earlier B7 design: device {EARLIER_B7_DEVICE_MS[B]} ms (PERF.md "
            f"section 6, not measured here)")
    say("timing", f"B={BIG} on {smi}: combo kernel single {kernel_single['kernel']:.4f} "
        f"ms vs plain {kernel_single['plain']:.4f} ms; "
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
    # Contiguous views that start one row into their buffer: 8-byte aligned
    # rows at F = 10,010, 4-byte aligned at F = 10,009 (exact copies lie on
    # the uniform pair's first off-diagonal); then the narrowest widths.
    shapes["offset"] = ((X[1:], S), (ut[1:], ut[:-1]))
    shapes["oddF_offset"] = tuple((A[1:], B_[1:]) for A, B_ in shapes["oddF"])
    for f in (1, 7):
        shapes[f"F{f}"] = ((X[:130, 4000:4000 + f].contiguous(),
                            X[130:259, 4000:4000 + f].contiguous()),
                           (uniform(130, f), uniform(129, f)))
    for A, B_ in shapes["offset"] + shapes["oddF_offset"]:
        check(A.is_contiguous() and A.storage_offset() > 0, "the offset cases' views")
    rbf_err = 0.0
    errs = {}  # (shape, kind, gamma) -> kernel error against float64
    signed = {}  # (kind, gamma) -> mean signed error (kernel, plain) at the serving shape
    lines = []
    for name, pairs in shapes.items():
        worst = []
        for kind, (A, B_) in zip(("real", "unif"), pairs):
            for gamma, ek, er, mk, mr in rbf_errors(A, B_, GAMMAS):
                check(ek <= 2.0 * er + 1e-6,
                      f"rbf kernel error {ek:.3e} > 2x plain {er:.3e} + 1e-6 at "
                      f"{name} {kind} gamma={gamma} {tuple(A.shape)}x{tuple(B_.shape)}")
                rbf_err = max(rbf_err, ek)
                errs[name, kind, gamma] = ek
                if name == "serving":
                    signed[kind, gamma] = (mk, mr)
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
        + "; ".join(lines) + "; every case within 2x plain + 1e-6; mean signed error "
        "K - K64 at the serving shape, kernel / plain: "
        + ", ".join(f"{kind} gamma {gamma}: {mk:.2e} / {mr:.2e}"
                    for (kind, gamma), (mk, mr) in signed.items())
        + f"; non-contiguous input raises; dataset made in {data_s:.1f} s")

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
    rbf_dev = {
        name: kernel_device_ms({"rbf": lambda A=A, B_=B_: rbf.rbf_gram(A, B_, cfg.gamma)},
                               RBF_SYMBOLS, reps=3, log=retrace)
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

    def peak_bytes(fn):
        """Peak device memory of fn() above what is held before it."""
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev) - held

    gram_peak = peak_bytes(lambda: rbf.rbf_gram(queries, S, cfg.gamma))
    gram_plain_peak = peak_bytes(lambda: rbf.rbf_gram_ref(queries, S, cfg.gamma))
    step_peak = peak_bytes(lambda: svc_pred(exact_in, txyz, tvalid))
    gram_ms = rbf_ms["serving"]["kernel"]
    rest = parts["step"] - gram_ms - parts["pair"] - parts["couple"]
    t0 = time.perf_counter()
    svc.svc_fit(X, np.asarray(labels), cfg)
    torch.cuda.synchronize()
    fit_warm_s = time.perf_counter() - t0
    say("svc timing", f"on {smi}: rbf kernel {gram_ms:.4f} ms vs plain "
        f"{rbf_ms['serving']['plain']:.4f} ms at {tuple(queries.shape)}x{n_sv} (device: "
        + ", ".join(f"{k} {v:.4f}" for k, v in rbf_dev["serving"].items())
        + f"; the earlier FP32-FMA kernel {EARLIER_B6_MS['serving']} ms, PERF.md section 6, not measured here), "
        f"{rbf_ms['training']['kernel']:.4f} ms vs {rbf_ms['training']['plain']:.4f} "
        f"ms at {tuple(X.shape)}x{X.shape[0]} (device: "
        + ", ".join(f"{k} {v:.4f}" for k, v in rbf_dev["training"].items())
        + f"; earlier {EARLIER_B6_MS['training']} ms); SVC exact B={BIG}: {svc_rate:.0f} "
        f"scans/s ({parts['step']:.4f} ms/batch = Gram {gram_ms:.4f} + pair product "
        f"{parts['pair']:.4f} + coupling {parts['couple']:.4f} (without its early "
        f"stop {parts['couple_100']:.4f}) + features and the rest {rest:.4f}); "
        f"svc_fit {fit_warm_s:.2f} s warm; peak device memory above what is held before "
        f"the call: one rbf_gram at the serving shape {gram_peak / 2**20:.1f} MiB (output "
        f"{queries.shape[0] * n_sv * 4 / 2**20:.1f} MiB, the rest the packed operands; plain "
        f"{gram_plain_peak / 2**20:.1f} MiB), one SVC exact step {step_peak / 2**20:.1f} MiB")

    # -- 11. apps ----------------------------------------------------------
    t0 = time.perf_counter()
    apps = phase_apps(dev, smi, g, gs, S.cpu().numpy(), fused, cubes, targets)
    say("apps", f"phase 11 in {time.perf_counter() - t0:.1f} s; gRPC {apps['grpc']}")

    # -- 12. train -----------------------------------------------------------
    t0 = time.perf_counter()
    train = phase_train(dev, smi)
    say("train", f"phase 12 in {time.perf_counter() - t0:.1f} s")

    def int8_record(name, source, replaces, n_launched, err):
        big, small = int8_ms[BIG][name], int8_ms[SMALL_B][name]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launched, "max_abs_err": err,
            "ms": big["kernel"], "plain_ms": big["plain"],
            "bound_ms": big["bound"], "bound_by": big["bound_by"], "library_ms": None,
            "device_ms": big["device"],
            "ms_b64": small["kernel"], "plain_ms_b64": small["plain"],
            "bound_ms_b64": small["bound"], "device_ms_b64": small["device"],
        }

    records = [int8_record("onepass_tables_combined_i8", KERNEL_SOURCE, REPLACES,
                           launches, max_err)
               | {"ms_single": kernel_single["kernel"],
                  "plain_ms_single": kernel_single["plain"], "scans_per_s": rates,
                  "launches_predict_app": apps["b1_predict"],
                  "launches_serve_app": apps["b1_serve"]}]
    for name, (tail, replaces) in TAIL_KERNELS.items():
        records.append(int8_record(name, KERNEL_SOURCE, replaces, tail_launches[name],
                                   tail_err[name])
                       | {"fused_tail": tail, "scans_per_s": rates[f"fused_{tail}"]})
    big, small = native_ms[BIG], native_ms[SMALL_B]
    records.append({
        "name": "fused_native_score", "route": "cuda", "source": NATIVE_SOURCE,
        "replaces": NATIVE_REPLACES, "launches": native_launches,
        "max_abs_err": native_err, "max_abs_err_vs_f64": native_f64,
        "ms": big["kernel"], "plain_ms": big["plain"], "bound_ms": big["bound"],
        "bound_by": big["bound_by"], "library_ms": None, "fast_f32_ms": big["fast_f32"],
        "device_ms": big["device"],
        "ms_b64": small["kernel"], "plain_ms_b64": small["plain"],
        "bound_ms_b64": small["bound"], "device_ms_b64": small["device"],
        "fast_f32_ms_b64": small["fast_f32"],
        "scans_per_s": {k: rates[k] for k in ("pallas", "pallas_f32", "fast")},
    })
    rbf_b, rbf_by = rbf_bound(queries, S)
    records.append({
        "name": "rbf_gram",
        "route": "cuda",
        "source": RBF_SOURCE,
        "replaces": RBF_REPLACES,
        "launches": launches_svc,
        "max_abs_err": rbf_err,
        "ms": rbf_ms["serving"]["kernel"],
        "plain_ms": rbf_ms["serving"]["plain"],
        "bound_ms": rbf_b,
        "bound_by": rbf_by,
        "bound_ms_fp32": rbf_bound(queries, S, FP32_FLOPS_S)[0],
        "library_ms": None,
        "device_ms": rbf_dev["serving"],
        "ms_training": rbf_ms["training"]["kernel"],
        "plain_ms_training": rbf_ms["training"]["plain"],
        "bound_ms_training": rbf_bound(X, X)[0],
        "bound_ms_fp32_training": rbf_bound(X, X, FP32_FLOPS_S)[0],
        "device_ms_training": rbf_dev["training"],
        "peak_bytes_call": gram_peak,
        "peak_bytes_svc_step": step_peak,
        "mean_signed_err_serving": {f"{kind} gamma {gamma}": mk
                                    for (kind, gamma), (mk, _) in signed.items()},
        "fit_launches": fit_launches,
        "launches_predict_app": apps["b6_predict"],
        "launches_train_app": train["launches_train_app"],
        "launches_train_app_implied": train["expected_train_app"],
        "train_shapes": train["shapes"],
        "svc_scans_per_s": svc_rate,
        "svc_fit_s": fit_warm_s,
    })
    say("profiler", f"{TRACES['taken']} traces taken for device times, {TRACES['lacking']} "
        f"of them without a kernel's records (each taken again)")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
