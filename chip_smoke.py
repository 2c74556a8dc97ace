"""Drive the PyTorch port's predict, SVC, serving, training, neural, artifact, capture, multi-device and reference-pickle paths on one CUDA card.

    python3 chip_smoke.py [--parent DIR]

With --parent DIR (a tree of an earlier commit, e.g. unpacked by git
archive), phase 6 also builds that tree's kernel sources and times them
beside this tree's in the same process.

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
             same bits. Past the earlier limits (one class group of 8 rows
             in B1-B5; 7 classes and Z <= 256 in B7): B1-B5 at C2 6
             (the finer arenas), 10 / 16 / 18 / 32 (levels 2) and 9 / 16
             (levels 1), B 1 / 7 / 64 / 133 at the default arena, B 4096
             there at C2 9 / 10 / 18 / 32 and at C2 10 (one block of two
             n-tiles) each plane masked and a cube 1 byte off alignment, B
             7 / 64 at the finer scan arenas 43x31x351, 22x31x351 and
             43x61x351 (Z = 351: the staged route), B 1024 at 43x31x351,
             each plane masked there and a cube 1 byte off alignment,
             equal to their plain versions, each plan at its batch (rows a
             block, slab width) the host mirror's; B7 within its bars at
             C 8 / 9 / 16 and at the finer arenas (C 1 / 2 / 3 / 5 / 9,
             the long-row instance; B 1024 and a cube 2 bytes off
             alignment at 43x31x351), B7's work plan (class groups,
             z-chunks) equal to the host's mirror of it.
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
             path's float32 tables (folded_tables) on the same cube; the
             lookup and
             glookup kernels' at B 1 / 7 / 64 / 131 / 132 / 133 with their
             plans (and the glookup plan at y-groups 5 / 16 / 31, which is
             one plan); fused
             (every tail) / fast int8 / fast f32 / pallas (bf16 and f32
             streams) / exact scans per second at B=4096 with inputs
             resident on the card; each table kernel's device time a call
             (its CUDA launches summed, their count printed) and bound at
             B=4096 and 64 at 9 classes (int8 C2 = 18: three class groups
             in one launch; B7 two launches), at 5 classes (C2 = 10: one
             block of two n-tiles a scan at B=4096, class groups at 64), at
             43x31x351 with 3 classes (B1-B5 on the staged route, B7 one
             long-row launch) and with 9; by CUDA events the fast path's
             float32 tables (B7's comparator) at 9 classes and at
             43x31x351 with 3; the C7 table (utils/route_bench): the demo
             model's exact, fast f32 and fast int8 steps at B 1 / 7 / 64 /
             128 / 4096 beside the einsums the fast modes replaced, fast
             int8's tables checked bit-equal to the int64 route's at every
             batch; the profiler traces' launch records against the
             launches their calls made. With
             --parent, the parent's kernel sources beside this tree's at
             B=4096 at the default arena (the same bits, profiler device
             times in the order parent, this, this, parent, twice) and at
             those four shapes at B=4096 and 64 (the int8 kernels' same
             bits, B7 each within its float64 bar; P N N P, twice at
             4096).
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
             profiler trace, whose launch records are counted against the
             launches), SVC exact scans per second at B=4096 and where its
             time goes, and svc_fit seconds (warm).
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
13. neural — the CNN and SGAN families at full width, no hand-written
             kernel on their path (cuDNN / cuBLAS in float32, TF32 off):
             the golden run of radarml_tpu_torch/assets/golden_neural.npz
             (the JAX package's outputs from seeds: CNN logits at 80x80;
             the discriminator's train-mode logits and statistics, pooled
             precise-BN statistics and eval-mode logits, the generator's
             eval outputs at 128x128; each family's predictor over 64
             scans) held to golden_neural_check's bars; the dnn app on
             make_dataset(2280, hardness=1.0) as a dataset pickle under its
             default schedule (100 epochs, patience 10, batch 64: epochs run,
             seconds an epoch in the app and warm, ms a step by CUDA events,
             one traced step's kernels, device ms and idle share, best val
             loss and accuracy, its history by epoch, peak memory) and the
             sgan app on the same data (128x128, n_batch 32, 150 supervised samples, 5 epochs:
             steps, seconds, ms a fused four-phase step by CUDA events and
             traced, both precise-BN recalibrations' ms, the c head's val
             accuracy, peak memory); each artifact served by the predict app
             in exact mode equal to a direct RadarPredictor call (1e-6).
             The kill-and-resume case of tests/test_torch_cnn.py (36
             samples at 16x16, and at 80x80; 12 epochs against 8 with a
             checkpoint every 4, then resumed from other weights): the
             resumed run's history and best parameters bit-equal to an
             uninterrupted run that checkpoints (train_cnn takes cuDNN's
             deterministic algorithms when it checkpoints or resumes); as
             controls, the same runs under cuDNN's default algorithms and
             the test's uninterrupted run without checkpoints, each
             reported equal or parted; a CNN step's ms under the default
             and the deterministic algorithms, interleaved. Its record is
             printed as a {"neural": ...} JSON line.
14. export — the serving artifacts (serving/export.py; the kernels as
             torch ops, ops/library.py) at full width, each exported,
             written, loaded back from its file on the card and called:
             fused under all five tails and combo single at a baked batch
             of 128 (called at 128 and 1, bit-equal to the live
             predictor), pallas (bf16), fast int8 at B 1 / 7 / 128 through
             one artifact, exact, the SVC exact at B=4096 and a CNN (80x80,
             bf16) — the others' decisions equal and probabilities within
             1e-6; each kernel's launch counter rises by exactly the
             artifact's calls (and no other counter moves); fast int8's
             CPU program equals a CPU predictor; an artifact whose sample
             inputs carry a pickled payload, in their place or as a second
             entry of the same name, is refused and the payload never runs
             (and which loader this torch's torch.export.load reaches is
             printed); the pallas artifact on a strided batch equals the
             live predictor, and its op refuses a strided cube on the card
             with no launch; the artifact step against the live step
             at B=128 (fused combo) and B=4096 (SVC) by CUDA events,
             interleaved medians. Then serve --serving_artifact over the
             native source (--max_batch 128, 8 s) while a thread re-exports
             an intercept-only model with another boosted class: a reload,
             predict_errors 0, the labels flip, latency p50 / p95 and
             scans/s printed. Then the closed loop of
             tests/test_closed_loop.py at the reference's capture size:
             500 samples captured through the fake camera (scans, samples,
             seconds), the SGD train app on them, serve --grpc_port with
             --reload_poll, train --online_learn on a second capture of
             500: a reload and changed probabilities. Then plot_dataset and
             a DatasetBrowser page to PNG where matplotlib imports (else
             one line says why not). Its record is printed as an
             {"export": ...} JSON line.
15. mesh   — the multi-device layer (radarml_tpu_torch/parallel/), each
             group's ranks in processes of their own (this script with
             --mesh-rank GROUP DIR, started by parallel/spawn.run_ranks
             with torchrun's environment, a store this process hosts and a
             deadline; each rank leaves its group with
             mesh.close_distributed and its exit code is printed). One
             rank on a
             group of its own (NCCL on cuda:0): make_dp_sgd_train_step
             (512 x 10,010) and the fused combo predictor at B=4096 on
             make_mesh(1) bit-equal to mesh=None. Two ranks sharing
             cuda:0 (gloo; each collective staged through host memory):
             RadarPredictor(mesh=...) at B=4096 x 4 slots on the demo
             model, fused under all five tails and combo single, pallas
             bf16, fast int8, exact, the SVC of phase 8 in exact mode and
             a CNN (80x80, 512 scans): each rank's half bit-equal to one
             device's call on it; fused bit-equal to the whole batch's
             call, the others' decisions equal and probabilities within
             1e-6 (the SVC's within MESH_SVC_ATOL, its decisions where the
             margin exceeds it); each rank's kernel counters up by exactly
             one call on its half; a step sharded (inputs on the card)
             against one device's. The SGD grid's l2 group (4 alphas, 5
             folds, 12 epochs) and the SVC reference grid (30 candidates)
             on the train cell's features (1,881 x 10,010): split scores
             equal (SVC within 1e-6), best parameters equal; each fold
             walked alone bit-equal to the same fold in the 5-fold stack,
             a 3-fold stack to its slice (the one-device controls run
             beside the ranks). The dnn app with
             --mesh 2 under python -m torch.distributed.run --standalone
             (3 epochs of
             make_dataset(2280)) against --mesh 0 run twice, all under
             cuDNN's deterministic algorithms (DNN_LAUNCHER): the first
             epoch's loss within rtol 1e-4, later epochs within twice one
             device's spread (its second run and its runs from weights one
             ulp up and down), the ranks' parameter digests equal; a
             control run whose ranks skip the gradient sums must leave
             those bars. Two fused SGAN steps at 128x128 (n_batch 32)
             against one device run twice and from weights one ulp up and
             down, under the same bars (deterministic too), with the same
             control. Any failed check fails the run. Its record is printed
             as a {"mesh": ...} JSON line.
16. reference — the reference's own sklearn pickles
             (radarml_tpu_torch/assets/reference_pickles/: a
             CalibratedClassifierCV over an SGDClassifier and an RBF SVC,
             both at 10,010 features, and a LabelEncoder) loaded through
             apps/common_cli's allow-list with no sklearn module imported
             (sklearn is not installed on the card's machine; the check
             holds wherever the script runs). RadarPredictors from the
             linear pickle in exact, fast int8, pallas (bf16) and fused
             under all five tails, and from the SVC pickle in exact mode,
             each called once on expected.npz's 64 scans (4 slots, one
             target) on the card: probabilities within 5e-5 of sklearn's
             (expected.npz) with decisions equal (the SVC within 1e-3,
             decisions where the margin exceeds 1e-3); fused decisions equal
             fast int8's (probabilities within 1e-6); each kernel's counter
             up by exactly its one call; each kernel against its plain
             version on this model and these scans (int8 tables bit-equal,
             B7 and B6 against float64 at most 2x the plain version's);
             each mode's step at B=64 (CUDA events); the predict app in a
             process of its own (--mode fused, 128 synthetic scans) equal to
             a direct call, without importing sklearn. Its record is
             printed as a {"reference": ...} JSON line.
17. shapes — the shapes past the table kernels' earlier limits, served:
             a 5-class and a 9-class random linear model at the default
             arena and the demo model at the 43x31x351 scan arena, B 64
             and 4096 (64 synthetic scans tiled), 4 slots, through
             exact / fast / fast int8 / fused (all five tails, and single)
             / pallas (bf16, f32): finite outputs of the model's class
             count, every fused split tail's decisions equal fast int8's
             (probabilities within 1e-6), pallas decisions equal fast
             f32's where the top-2 margin exceeds 1e-4, each kernel's
             counter up by exactly its calls; the predict app in a process
             of its own, --mode fused with split and single quantization
             and --scan_arena 10,360,1,-42,42,2,-30,30,2 (the app has no
             pallas mode), equal to direct calls; the demo model at
             43x31x351, B=4096, each mode's step by CUDA events and each
             table kernel's device time a call, the traces' launch
             records against the launches; the C7 table at 43x31x351 (as
             phase 6's). Its record is printed as a {"shapes": ...} JSON
             line.

Every phase's seconds are printed as it ends ([time] lines).

Each kernel's launch count is reset just before its main path and read
just after: the int8 kernels and B7 over phases 4-5 (each fused tail's
kernel on its own tail's path, B7 on the pallas path), the RBF kernel
over phase 9 (and, reported apart, over the fit of phase 8); B1's and B6's
again over phase 11's predict app and B1's over its serve loop, reported
apart as launches_predict_app / launches_serve_app; B6's over phase 12's
SVC train app, as launches_train_app beside the count the path implies,
with its ms at the train path's two shapes (train_shapes); and every
kernel's over phase 14's artifact calls, as launches_export (B1's also
over the artifact serve loop, launches_export_serve); and each rank's
over phase 15's sharded call, as launches_mesh ([rank 0, rank 1]; the
int8 kernels on their tail's path, B7 on pallas, B6 on the SVC); and
every kernel's over phase 16's calls on the reference pickles, as
launches_reference; and over phase 17's calls at the new shapes, as
launches_shapes (beside device_ms_shapes, phase 6's device ms a call
there, with the CUDA launches a call).
bound_ms is
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
carries the fast path's float32 tables as fast_f32_ms instead, and at
43x31x351 as fast_f32_ms_43x31x351). The line
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
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from radarml_tpu_torch.apps import common_cli  # noqa: E402
from radarml_tpu_torch.apps import predict as predict_app  # noqa: E402
from radarml_tpu_torch.apps import serve as serve_app  # noqa: E402
from radarml_tpu_torch.apps import train as train_app  # noqa: E402
from radarml_tpu_torch.core.arena import (  # noqa: E402
    DEFAULT_ARENA,
    RADAR_MAX,
    Arena,
    derive_targets,
)
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
from radarml_tpu_torch.models.pipeline import (  # noqa: E402
    EXACT_BLOCK_BYTES,
    M1_SLAB_BYTES,
    RadarPredictor,
    folded_tables,
    pad_targets,
)
from radarml_tpu_torch.ops import _cuda_build  # noqa: E402
from radarml_tpu_torch.ops import i8_score, i8_tails, rbf, score  # noqa: E402
from radarml_tpu_torch.ops.features import FeatureSpec, process_samples  # noqa: E402
from radarml_tpu_torch.serving.stream import StreamConfig, StreamingClassifier  # noqa: E402
from radarml_tpu_torch.train.gridsearch import SGD_PARAM_GRID, parameter_grid  # noqa: E402
from radarml_tpu_torch.train.trainer import deterministic_cudnn  # noqa: E402
from radarml_tpu_torch.utils import kernel_probe, route_bench  # noqa: E402
from radarml_tpu_torch.utils.route_bench import cuda_ms, interleaved  # noqa: E402
from radarml_tpu_torch.utils.profiling import (  # noqa: E402
    TRACES, kernel_device_calls, kernel_device_ms)

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


def synthetic_scans(n: int, seed: int, arena=DEFAULT_ARENA):
    """The first n scans of `--driver synthetic --driver_seed seed` (at
    the apps' --scan_arena `arena`), as the apps see them: (cubes, target
    lists)."""
    cubes, lists = [], []
    with RadarSession(SyntheticRadar(arena=arena, seed=seed, max_targets=2)) as r:
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


# -- phase 13: the neural families -------------------------------------------

NEURAL_ASSET = os.path.join(HERE, "radarml_tpu_torch", "assets", "golden_neural.npz")
N_GOLD_SCANS = 64
# The bars of the golden run (tests/test_torch_neural_golden.py explains
# them): network outputs within NEURAL_OUT_TOL x max|golden|, BatchNorm
# statistics within NEURAL_OUT_TOL (1 + |golden|), probabilities within
# NEURAL_PROBA_ATOL and decisions equal where the golden top-2 margin
# exceeds NEURAL_MARGIN.
NEURAL_OUT_TOL, NEURAL_PROBA_ATOL, NEURAL_MARGIN = 1e-4, 1e-4, 1e-3
# The SGAN app's epochs on the card: 5, cut from the reference's 15
# (sgan.py:800-810), which took 212 s of a 284 s phase 13 on an H100
# (PERF.md section 4), to keep the phase near 150 s.
SGAN_EPOCHS = 5
N_NEURAL_SCANS, NEURAL_BATCH = 128, 64  # scans served by the predict app, a batch


def flat_stats(state) -> np.ndarray:
    """The BatchNorm running statistics of a state dict, flat, in sorted
    key order (the golden asset's layout)."""
    return np.concatenate([
        state[k].detach().cpu().numpy().ravel() for k in sorted(state)
        if k.endswith(("running_mean", "running_var"))])


def golden_neural_inputs(g) -> dict:
    """The golden run's inputs, made from its seeds with numpy: views for
    the CNN (80x80) and the discriminator (128x128), latents, and 64
    synthetic scans with 1 or 2 target slots each."""
    rng = np.random.default_rng(int(g["input_seed"]))
    out = {"x_cnn": rng.uniform(-1, 1, (16, 80, 80, 3)).astype(np.float32),
           "x_disc": rng.uniform(-1, 1, (8, 128, 128, 3)).astype(np.float32),
           "x_eval": rng.uniform(-1, 1, (8, 128, 128, 3)).astype(np.float32),
           "z": rng.standard_normal((2, 100)).astype(np.float32)}
    cubes, targets = make_scan_batch(N_GOLD_SCANS, seed=int(g["scan_seed"]), hardness=1.0)
    lists = [[(t.x, t.y, t.z), (t.x + 9.0, t.y - 6.0, t.z + 25.0)][: 1 + b % 2]
             for b, t in enumerate(targets)]
    out["cubes"] = cubes
    out["xyz"], out["valid"] = pad_targets(lists, 2)
    return out


def golden_neural_record(dev, g, n_scans: int = N_GOLD_SCANS) -> dict:
    """The port's side of the golden run on `dev`, through the port's own
    weight init (from the asset's seeds), modules and RadarPredictor:
    CNN logits; the discriminator's train-mode logits and statistics after
    that call, its pooled (precise-BN) statistics over the same batch and
    its eval-mode logits under them; the generator's eval-mode outputs
    (every 4th pixel); each family's predictor over the first `n_scans`
    scans."""
    from radarml_tpu_torch.models.cnn import init_cnn
    from radarml_tpu_torch.models.sgan import (Discriminator, Generator, sgan_init_trees,
                                               sgan_params_from_numpy)
    from radarml_tpu_torch.train.sgan_trainer import pooled_disc_stats

    inp = golden_neural_inputs(g)
    t = {k: torch.as_tensor(v, device=dev) for k, v in inp.items() if k.startswith(("x_", "z"))}
    out = {}
    with torch.no_grad():
        cnn_model = init_cnn(3, (80, 80), seed=int(g["cnn_seed"]), device=dev)
        out["cnn_logits"] = cnn_model(t["x_cnn"])
        (gp, gs), (dp, ds) = sgan_init_trees(3, (128, 128), seed=int(g["sgan_seed"]))
        gen, disc = Generator(4), Discriminator(3, (128, 128))
        gen.load_state_dict(sgan_params_from_numpy(gp, gs))
        disc.load_state_dict(sgan_params_from_numpy(dp, ds))
        gen, disc = gen.to(dev), disc.to(dev)
        out["disc_train"] = disc(t["x_disc"], train=True)
        out["disc_train_stats"] = flat_stats(disc.state_dict())
        pooled = pooled_disc_stats(disc, t["x_disc"][None])
        disc.load_state_dict(pooled, strict=False)
        out["disc_pooled_stats"] = flat_stats(pooled)
        out["disc_eval"] = disc(t["x_eval"], train=False)
        out["gen_eval"] = torch.cat(gen(t["z"], train=False), -1)[:, ::4, ::4]
    for fam, module, rescale in (("cnn", cnn_model, (80, 80)), ("sgan", disc, (128, 128))):
        model = common_cli.neural_classifier(module, rescale, dev)
        pred, _, proba = RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, model, min_proba=0.0,
                                        device=dev)(inp["cubes"][:n_scans],
                                                    inp["xyz"][:n_scans],
                                                    inp["valid"][:n_scans])
        out[f"{fam}_pred"], out[f"{fam}_proba"] = pred, proba
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def golden_neural_check(got: dict, g: dict) -> dict:
    """Hold a golden_neural_record to the asset's JAX outputs (over as many
    scans as `got` has); returns what was measured, each output's error
    as a share of its bar. Raises AssertionError past a bar."""
    out = {}
    for k in ("cnn_logits", "disc_train", "disc_eval", "gen_eval"):
        err = float(np.abs(got[k] - g[k]).max())
        out[k] = err / (NEURAL_OUT_TOL * float(np.abs(g[k]).max()))
    for k in ("disc_train_stats", "disc_pooled_stats"):
        out[k] = float((np.abs(got[k] - g[k]) / (NEURAL_OUT_TOL * (1 + np.abs(g[k])))).max())
    n = got["cnn_proba"].shape[0]
    valid = golden_neural_inputs(g)["valid"][:n]
    for fam in ("cnn", "sgan"):
        want, proba = g[f"{fam}_proba"][:n], got[f"{fam}_proba"]
        out[f"{fam}_proba"] = float(np.abs(proba - want)[valid].max()) / NEURAL_PROBA_ATOL
        top2 = np.sort(want, axis=-1)
        sure = valid & (top2[..., -1] - top2[..., -2] > NEURAL_MARGIN)
        out[f"{fam}_decided"] = int(sure.sum())
        check(np.array_equal(got[f"{fam}_pred"][sure], g[f"{fam}_pred"][:n][sure]),
              f"{fam} predictor decisions differ from the golden")
        check((got[f"{fam}_pred"][~valid] == -1).all(), f"{fam}: a padded slot was classified")
    bad = {k: v for k, v in out.items() if not k.endswith("_decided") and not v <= 1.0}
    check(not bad, f"off the golden (error / bar): {bad}")
    return out


def device_share(fn, reps: int, top_n: int = 6) -> dict:
    """One torch.profiler trace of `reps` calls of fn: the window's wall ms
    (host clock, synchronized), the kernels' summed device ms, their
    count, the device's idle share of the window, and the `top_n` kernels
    by device ms (name, ms and launches a call), all per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    TRACES["taken"] += 1
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    check(kernels and busy > 0, "the profiler trace shows no device time")
    by_name = {}
    for e in kernels:
        ms_n = by_name.setdefault(e.name[:70], [0.0, 0])
        ms_n[0] += e.time_range.elapsed_us() / 1e3 / reps
        ms_n[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    return {"wall_ms": wall / reps, "device_ms": busy / reps,
            "kernels": len(kernels) / reps, "idle_share": max(0.0, 1.0 - busy / wall),
            "top": [(name, ms, n // reps) for name, (ms, n) in top]}


def separable(n, rescale, seed, scale=0.1):
    """tests/test_torch_cnn.py's fixture: class c lifts view c by 1."""
    rng = np.random.default_rng(seed)
    y = (np.arange(n) % 3).astype(np.int64)
    X = rng.normal(size=(n,) + rescale + (3,)).astype(np.float32) * scale
    for c in range(3):
        X[y == c, :, :, c] += 1.0
    return X, y


def kill_and_resume(d, dev, rescale, tag) -> dict:
    """tests/test_torch_cnn.py's kill-and-resume case on the card: an
    uninterrupted 12-epoch run (without checkpoints, the test's, and with
    them), an 8-epoch run killed after its checkpoint at 8 and resumed from
    other weights to 12. Whether the resumed run equals each uninterrupted
    one, bit for bit (history and best parameters)."""
    from radarml_tpu_torch.models.cnn import init_cnn
    from radarml_tpu_torch.train.trainer import TrainConfig, train_cnn

    X, y = separable(36, rescale, 3)
    Xv, yv = X[:12], y[:12]
    cfg = TrainConfig(batch_size=12, epochs=12, patience=50)

    def run(seed, config, ckpt=None, resume=False):
        return train_cnn(init_cnn(3, rescale, seed=seed, device=dev), X, y, Xv, yv,
                         config=config, checkpoint_dir=ckpt, checkpoint_every=4,
                         resume=resume)

    plain = run(0, cfg)
    whole = run(0, cfg, os.path.join(d, f"whole_{tag}"))
    killed = os.path.join(d, f"killed_{tag}")
    run(0, TrainConfig(batch_size=12, epochs=8, patience=50), killed)
    resumed = run(9, cfg, killed, resume=True)

    def same(a, b):
        return a[1] == b[1] and all(torch.equal(a[0][k], b[0][k]) for k in a[0])

    return {"equal_checkpointed": same(resumed, whole), "equal_test_form": same(resumed, plain),
            "whole_equal_plain": same(whole, plain),
            "last_val_loss": [whole[1]["val_loss"][-1], resumed[1]["val_loss"][-1]]}


def resume_check(d, dev) -> dict:
    """C5 on the card: kill_and_resume at the test's 16x16 and at 80x80,
    as shipped (checks: the resumed run equals the uninterrupted run that
    checkpoints) and, as a control, with train_cnn's deterministic cuDNN
    taken out (reported)."""
    import contextlib

    from radarml_tpu_torch.train import trainer

    out = {}
    for rescale in ((16, 16), (80, 80)):
        name = f"{rescale[0]}x{rescale[1]}"
        out[name] = kill_and_resume(d, dev, rescale, name)
        check(out[name]["equal_checkpointed"],
              f"C5: the resumed CNN run at {name} parts from the uninterrupted one")
        shipped = trainer.deterministic_cudnn
        trainer.deterministic_cudnn = contextlib.nullcontext
        try:
            out[f"{name}_default_cudnn"] = kill_and_resume(d, dev, rescale, f"{name}_default")
        finally:
            trainer.deterministic_cudnn = shipped
    return out


def phase_neural(dev, smi) -> dict:
    """Phase 13: the neural families on the card, with the artifacts in a
    temporary directory."""
    with tempfile.TemporaryDirectory() as d:
        return neural_in(d, dev, smi)


def neural_in(d, dev, smi) -> dict:
    from radarml_tpu_torch.apps import dnn as dnn_app
    from radarml_tpu_torch.apps import sgan as sgan_app
    from radarml_tpu_torch.models.cnn import dropout_masks, init_cnn
    from radarml_tpu_torch.train import sgan_trainer as st
    from radarml_tpu_torch.train.trainer import (TrainConfig, make_cnn_step,
                                                 seeded_generator, train_cnn)

    logging.getLogger("radarml_tpu_torch").setLevel(logging.WARNING)
    res = {}
    # a. the golden run at full width
    t0 = time.perf_counter()
    with np.load(NEURAL_ASSET) as f:
        g = {k: f[k] for k in f.files}
    res["golden"] = golden_neural_check(golden_neural_record(dev, g), g)
    say("neural", f"golden (radarml_tpu_torch/assets/golden_neural.npz: CNN 80x80, SGAN "
        f"128x128 n_upsamples 4, {N_GOLD_SCANS} scans each family) in "
        f"{time.perf_counter() - t0:.1f} s; error / bar: "
        + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in res["golden"].items()))

    ds = os.path.join(d, "neural.pickle")
    write_dataset(ds, N_TRAIN, 1234, TRAIN_HARDNESS)
    le_path = os.path.join(d, "neural_le.pkl")

    # b. the dnn app at the reference data scale and default schedule; peak
    # memory is read above what earlier phases still hold
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = dnn_app.main(["--datasets", ds, "--results_dir", os.path.join(d, "dnn")])
    torch.cuda.synchronize()
    app_s = time.perf_counter() - t0
    cnn_peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    hist, classes = out["history"], out["classes"]
    epochs = len(hist["loss"])
    best = int(np.argmin(hist["val_loss"]))
    n_train = int(N_TRAIN * 0.8)
    steps_per_epoch = n_train // 64
    model = init_cnn(3, (80, 80), seed=1234, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=2e-4, betas=(0.5, 0.999), fused=True)
    step = make_cnn_step(model, opt, torch.ones(3, device=dev))
    rng_t = seeded_generator(dev, 0, 0)
    xb = torch.rand((64, 80, 80, 3), generator=rng_t, device=dev) * 2 - 1
    yb = torch.randint(0, 3, (64,), generator=rng_t, device=dev)
    cnn_step = lambda: step(xb, yb, dropout_masks(2, (64, 64), 0.5, rng_t))  # noqa: E731
    def cnn_step_replay():
        with deterministic_cudnn():
            return cnn_step()

    both_ms = interleaved({"step": cnn_step, "deterministic": cnn_step_replay},
                          inner=20, rounds=5)
    step_ms = both_ms["step"]
    cnn_share = device_share(cnn_step, 20)
    # a warm epoch: train_cnn at the app's shapes, after a run that warms
    # cuDNN (the app's own epochs include its first-call set-up)
    Xw = torch.rand((N_TRAIN, 80, 80, 3), generator=rng_t, device=dev) * 2 - 1
    yw = np.arange(N_TRAIN) % 3
    warm_cfg = TrainConfig(epochs=1)
    train_cnn(init_cnn(3, (80, 80), device=dev), Xw[:n_train], yw[:n_train],
              Xw[n_train:], yw[n_train:], config=warm_cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_cnn(init_cnn(3, (80, 80), device=dev), Xw[:n_train], yw[:n_train],
              Xw[n_train:], yw[n_train:], config=TrainConfig(epochs=3, patience=100))
    torch.cuda.synchronize()
    warm_epoch_s = (time.perf_counter() - t0) / 3
    res["cnn"] = {"epochs": epochs, "s_per_epoch": out["train_seconds"] / epochs,
                  "s_per_epoch_warm": warm_epoch_s, "ms_per_step": step_ms,
                  "ms_per_step_deterministic": both_ms["deterministic"],
                  "steps_per_epoch": steps_per_epoch, "app_s": app_s,
                  "best_val_loss": hist["val_loss"][best],
                  "best_val_accuracy": hist["val_accuracy"][best],
                  "peak_mib": cnn_peak, "trace": cnn_share}
    common_cli.save_label_encoder(le_path, LabelEncoder(tuple(classes)))
    n_ans, d_cnn = predict_matches_direct(d, dev, out["model_path"], le_path, classes,
                                          "exact", N_NEURAL_SCANS, NEURAL_BATCH)
    say("neural", f"on {smi}: dnn app on make_dataset({N_TRAIN}, hardness {TRAIN_HARDNESS}) "
        f"(TrainConfig defaults: 100 epochs, patience 10, batch 64; {steps_per_epoch} steps an "
        f"epoch): {epochs} epochs in {out['train_seconds']:.2f} s "
        f"({res['cnn']['s_per_epoch']:.3f} s an epoch, warm {warm_epoch_s:.3f} s; app "
        f"{app_s:.2f} s with data and preprocessing); best val loss "
        f"{hist['val_loss'][best]:.4f}, val accuracy {hist['val_accuracy'][best]:.4f} "
        f"(epoch {best + 1}); one step (batch 64, 80x80) "
        f"{step_ms:.3f} ms (CUDA events), traced: {cnn_share['kernels']:.0f} kernels, device "
        f"{cnn_share['device_ms']:.3f} of {cnn_share['wall_ms']:.3f} ms wall (idle share "
        f"{cnn_share['idle_share']:.3f}; most device time: " + "; ".join(
            f"{n} {ms:.3f} ms x{k}" for n, ms, k in cnn_share["top"])
        + f"); peak device memory of the app {cnn_peak:.1f} MiB above what was held; "
        f"predict --mode exact over c_model.pickle, {N_NEURAL_SCANS} scans: {n_ans} targets "
        f"== a direct RadarPredictor call (proba delta {d_cnn:.2e})")
    res["cnn"]["history"] = {k: [float(v) for v in hist[k]] for k in
                             ("loss", "val_loss", "accuracy", "val_accuracy")}
    say("neural", "the dnn app's history by epoch: " + "; ".join(
        f"{k} " + ", ".join(f"{v:.4f}" for v in vals)
        for k, vals in res["cnn"]["history"].items()))

    # c. C5: kill and resume on the card
    t0 = time.perf_counter()
    res["resume"] = resume_check(d, dev)
    say("neural", f"on {smi}: kill-and-resume (tests/test_torch_cnn.py's case, 12 epochs "
        f"against 8 + resume) in {time.perf_counter() - t0:.1f} s, the resumed run bit-equal "
        "to: " + "; ".join(
            f"{k}: the uninterrupted run with checkpoints {v['equal_checkpointed']}, without "
            f"(the test's form) {v['equal_test_form']}; the two uninterrupted runs "
            f"{v['whole_equal_plain']}; last val loss {v['last_val_loss'][0]:.9g} / "
            f"{v['last_val_loss'][1]:.9g}" for k, v in res["resume"].items())
        + f"; a CNN step (batch 64, 80x80) {step_ms:.3f} ms under cuDNN's default "
        f"algorithms, {both_ms['deterministic']:.3f} ms under its deterministic ones "
        "(CUDA events, interleaved)")

    # d. the sgan app at 128x128 (n_batch 32, 150 supervised samples)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = sgan_app.main(["--datasets", ds, "--results_dir", os.path.join(d, "sgan"),
                         "--epochs", str(SGAN_EPOCHS)])
    torch.cuda.synchronize()
    app_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    state = out["state"]
    gen_m, disc_m = state.gen, state.disc
    cfg = st.SGANConfig(n_classes=3)
    sgan_step = st.make_sgan_step(gen_m, disc_m, cfg)
    sv = torch.rand((16, 128, 128, 3), generator=rng_t, device=dev) * 2 - 1
    sl = torch.randint(0, 3, (16,), generator=rng_t, device=dev)
    fused = lambda: sgan_step(state, sv, sl, sv, st.draw_step(cfg, 16, disc_m, rng_t))  # noqa: E731
    fused_ms = interleaved({"step": fused}, inner=5, rounds=3)["step"]
    sgan_share = device_share(fused, 5)
    Xr = torch.rand((256, 128, 128, 3), generator=rng_t, device=dev) * 2 - 1
    recal = {"disc": lambda: st.recalibrate_bn_stats(disc_m, state, Xr),
             "gen": lambda: st.recalibrate_gen_stats(gen_m, state, rng_t, cfg.latent_dim)}
    recal_ms = interleaved(recal, inner=2, rounds=3)
    n_sgan = len(out["classes"])
    res["sgan"] = {"epochs": SGAN_EPOCHS, "steps": out["steps"], "app_s": app_s,
                   "train_s": out["train_seconds"],
                   "ms_per_fused_step": fused_ms, "recal_ms": recal_ms,
                   "val_accuracy": out["val_accuracy"], "peak_mib": peak, "trace": sgan_share}
    n_ans, d_sgan = predict_matches_direct(d, dev, out["model_path"], le_path, out["classes"],
                                           "exact", N_NEURAL_SCANS, NEURAL_BATCH)
    say("neural", f"on {smi}: sgan app on the same data (128x128, n_batch 32, 150 supervised "
        f"samples, {SGAN_EPOCHS} epochs, {n_sgan} classes): {out['steps']} steps in "
        f"{out['train_seconds']:.2f} s ({out['steps'] / out['train_seconds']:.2f} steps/s with "
        f"the epochs' recalibrations and summaries; app {app_s:.2f} s); one fused four-phase "
        f"step {fused_ms:.3f} ms (CUDA events; "
        f"{1e3 / fused_ms:.1f} steps/s), traced: {sgan_share['kernels']:.0f} kernels, device "
        f"{sgan_share['device_ms']:.3f} of {sgan_share['wall_ms']:.3f} ms wall (idle share "
        f"{sgan_share['idle_share']:.3f}; most device time: " + "; ".join(
            f"{n} {ms:.2f} ms x{k}" for n, ms, k in sgan_share["top"])
        + f"); precise-BN recalibration disc {recal_ms['disc']:.3f} "
        f"ms, gen {recal_ms['gen']:.3f} ms; c-head val accuracy {out['val_accuracy']:.4f}; peak "
        f"device memory of the app {peak:.1f} MiB above what was held; predict --mode exact "
        f"over c_model.pickle, "
        f"{N_NEURAL_SCANS} scans: {n_ans} targets == a direct RadarPredictor call (proba "
        f"delta {d_sgan:.2e})")
    return res


# -- phase 14: the serving artifact and the capture loop ----------------------

EXPORT_BATCH, SVC_EXPORT_B = 128, 4096  # the fused artifacts' baked batch; the SVC's call
N_CAPTURE, CAPTURE_MAX_SCANS = 500, 5000  # the reference's default capture, and a bound
ARTIFACT_SERVE_S = 8  # the re-export, its settling and the swap's warm-up fit in it
FUSED_KERNEL = {"combo": "onepass_tables_combined_i8",
                **{tail: name for name, (tail, _) in TAIL_KERNELS.items()}}


def launch_counts() -> dict:
    """Every kernel's launch counter, under its record's name."""
    return {"onepass_tables_combined_i8": i8_score.KERNEL_LAUNCHES, **i8_tails.LAUNCHES,
            "fused_native_score": score.KERNEL_LAUNCHES, "rbf_gram": rbf.KERNEL_LAUNCHES}


def rise(before: dict) -> dict:
    return {k: v - before[k] for k, v in launch_counts().items()}


def loader_report(d, art_path, device) -> str:
    """Which loader torch.export.load reaches in this torch, and that an
    artifact whose sample inputs are a pickle with a __reduce__ payload is
    refused (ValueError) and the payload never runs: in their place, and
    as a second entry of the same name before or after the harmless one."""
    import inspect
    import io
    import warnings
    import zipfile

    from torch._export.serde import serialize as serde
    from radarml_tpu_torch.serving import load_serving_artifact
    from radarml_tpu_torch.serving.export import MAGIC

    pt2 = importlib.util.find_spec("torch.export.pt2_archive._package") is not None
    retries = "weights_only=False" in inspect.getsource(serde.deserialize_torch_artifact)
    marker = os.path.join(d, "payload_ran")

    class Payload:
        def __reduce__(self):
            return (open, (marker, "w"))

    evil = io.BytesIO()
    torch.save(Payload(), evil)
    raw = open(art_path, "rb").read()
    head, _, blob = raw[len(MAGIC):].partition(b"\n")
    meta = json.loads(head)
    off = 0
    for p, n in meta["programs"].items():  # keep only this device's program
        if p == device.type:
            blob = blob[off:off + n]
        off += n
    src = zipfile.ZipFile(io.BytesIO(blob))
    refused = {}
    for how in ("in place", "first of two", "second of two"):
        entries = {"in place": (evil.getvalue(),), "first of two": (evil.getvalue(), None),
                   "second of two": (None, evil.getvalue())}[how]
        out = io.BytesIO()
        with zipfile.ZipFile(out, "w") as dst, warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # "Duplicate name"
            for name in src.namelist():
                data = src.read(name)
                for e in entries if name.endswith("data/sample_inputs/model.pt") else (data,):
                    dst.writestr(name, data if e is None else e)
        meta["programs"] = {device.type: len(out.getvalue())}
        bad = os.path.join(d, "evil.rmlx")
        with open(bad, "wb") as fp:
            fp.write(MAGIC + json.dumps(meta).encode() + b"\n" + out.getvalue())
        try:
            load_serving_artifact(bad, device=device)
        except ValueError as e:
            refused[how] = str(e).split(": ", 2)[-1]
        else:
            raise AssertionError(f"an artifact with a pickled payload ({how}) loaded")
        check(not os.path.exists(marker), f"the payload of a refused artifact ({how}) ran")
    return (f"torch {torch.__version__}: torch.export.load reads a pt2 archive "
            f"({'pt2_archive._package.load_pt2' if pt2 else 'the legacy zip path'}); its "
            f"sample-input loader {'retries a failed weights_only load with the full unpickler' if retries else 'does not retry with the full unpickler'}; "
            "a payload in the sample inputs is refused before it and never ran: "
            + "; ".join(f"{k}: {v}" for k, v in refused.items()))


def phase_export(dev, smi, g, svc_pred) -> dict:
    """Phase 14: serving artifacts, serving from one with hot reload, the
    capture -> retrain -> reload loop and the plots, in a temporary
    directory. Returns the kernels' launches over the artifacts' calls
    and over the artifact serve loop."""
    with tempfile.TemporaryDirectory() as d:
        return export_in(d, dev, smi, g, svc_pred)


def export_in(d, dev, smi, g, svc_pred) -> dict:
    import pickle

    from radarml_tpu_torch.models import cnn
    from radarml_tpu_torch.ops.i8_score import encode_int8_cubes
    from radarml_tpu_torch.serving import export_predictor, load_serving_artifact

    logging.getLogger("radarml_tpu_torch").setLevel(logging.WARNING)
    classes = [str(c) for c in g["classes"]]
    model, calib = from_numpy(g["coef"], g["intercept"], g["calib_a"], g["calib_b"],
                              device=dev)
    kw = dict(train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA, model=model,
              calibration=calib, min_proba=float(g["min_proba"]), device=dev)
    cubes, targets = make_scan_batch(N_SLICE, seed=int(g["scan_seed"]))
    cubes = np.rint(cubes).astype(np.float32)
    xyz, valid = pad_targets([[(t.x, t.y, t.z)] for t in targets], max_targets=4)
    reps = -(-SVC_EXPORT_B // N_SLICE)
    tiled = (np.tile(cubes.astype(np.uint8), (reps, 1, 1, 1)), np.tile(xyz, (reps, 1, 1)),
             np.tile(valid, (reps, 1)))

    def batch(B):  # the first B scans (tiled past N_SLICE), uint8 on the host
        return tuple(a[:B] for a in tiled)

    cnn_path = os.path.join(d, "cnn.pkl")  # the dnn app's artifact kind, at 80x80
    with open(cnn_path, "wb") as fp:
        pickle.dump({"format": "radarml_tpu.v1", "kind": "cnn", "classes": classes,
                     "params": cnn.cnn_init_tree(len(classes), (80, 80), seed=3),
                     "rescale": (80, 80)}, fp)
    net, _ = common_cli.load_model(cnn_path, device=dev)
    # name -> (live predictor, static batch, batches called, the kernel it runs)
    specs = {f"fused_{tail}": (RadarPredictor(mode="fused", fused_tail=tail, **kw),
                               EXPORT_BATCH, (EXPORT_BATCH, 1), kernel)
             for tail, kernel in FUSED_KERNEL.items()}
    specs["fused_single"] = (RadarPredictor(mode="fused", fused_quant="single", **kw),
                             EXPORT_BATCH, (EXPORT_BATCH, 1), "onepass_tables_combined_i8")
    specs["pallas"] = (RadarPredictor(mode="pallas", cube_dtype="bfloat16", **kw), None,
                       (EXPORT_BATCH, 1), "fused_native_score")
    specs["fast_i8"] = (RadarPredictor(mode="fast", cube_dtype="int8", **kw), None,
                        (1, 7, EXPORT_BATCH), None)
    specs["exact"] = (RadarPredictor(mode="exact", **kw), None, (EXPORT_BATCH, 1), None)
    specs["svc_exact"] = (svc_pred, None, (SVC_EXPORT_B,), "rbf_gram")
    specs["cnn"] = (RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, net, min_proba=0.0,
                                   cube_dtype="bfloat16", device=dev), None,
                    (EXPORT_BATCH, 1), None)

    launches = dict.fromkeys(launch_counts(), 0)
    arts, lines = {}, []
    for name, (p, static, calls, kernel) in specs.items():
        path = os.path.join(d, f"{name}.rmlx")
        t0 = time.perf_counter()
        meta = export_predictor(p, path, max_targets=4, batch=static,
                                platforms=("cuda", "cpu") if name == "fast_i8" else None)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        art = arts[name] = load_serving_artifact(path)
        load_s = time.perf_counter() - t0
        check(art.device.type == "cuda" and art.batch == static,
              f"{name}: loaded on {art.device} with batch {art.batch}")
        before = launch_counts()
        got = []
        for B in calls:
            got.append(art(*batch(B)))
            torch.cuda.synchronize()
        up = rise(before)
        want_up = {k: len(calls) if k == kernel else 0 for k in up}
        check(up == want_up, f"{name}: launches over the artifact's calls {up} != {want_up}")
        for k, v in up.items():
            launches[k] += v
        worst = 0.0
        for B, out in zip(calls, got):
            live = p(*batch(B))
            check(all(o.device.type == "cuda" for o in out), f"{name} left the card")
            if p.mode == "fused":
                check(all(torch.equal(a, b) for a, b in zip(live, out)),
                      f"{name} artifact != live predictor at B={B}")
            else:
                check(torch.equal(live[0], out[0]), f"{name} artifact decisions at B={B}")
                worst = max(worst, float((live[2] - out[2]).abs().max()))
        check(worst <= 1e-6, f"{name} artifact proba vs live {worst}")
        lines.append(f"{name} ({meta['platforms']}, batch {static or 'symbolic'}, "
                     f"{sum(meta['programs'].values()) / 2**20:.1f} MiB) export "
                     f"{export_s:.2f} s, load {load_s:.2f} s, B {'/'.join(map(str, calls))}: "
                     + ("bit-equal" if p.mode == "fused" else f"proba delta {worst:.1e}")
                     + (f", {kernel} +{len(calls)}" if kernel else ", no kernel"))
    say("export", f"on {smi}: artifacts loaded from their files == the live predictors, "
        "kernels counted over the artifacts' calls only: " + "; ".join(lines))

    # the CPU program of the same linear artifact against a CPU predictor
    art_cpu = load_serving_artifact(os.path.join(d, "fast_i8.rmlx"), device="cpu")
    cmodel, ccalib = from_numpy(g["coef"], g["intercept"], g["calib_a"], g["calib_b"],
                                device="cpu")
    cpu_pred = RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, cmodel, ccalib,
                              min_proba=float(g["min_proba"]), mode="fast", cube_dtype="int8",
                              device="cpu")
    c7 = batch(7)
    want, out = cpu_pred(*c7), art_cpu(*c7)
    check(all(o.device.type == "cpu" for o in out), "the CPU program left the CPU")
    check(torch.equal(want[0], out[0]), "the CPU program's decisions != a CPU predictor's")
    d_cpu = float((want[2] - out[2]).abs().max())
    check(d_cpu <= 1e-6, f"the CPU program vs a CPU predictor: proba delta {d_cpu}")
    say("export", f"fast_i8's CPU program == a CPU predictor at B=7 (proba delta "
        f"{d_cpu:.1e}); " + loader_report(d, os.path.join(d, "fused_combo.rmlx"), dev))

    # A strided cube batch (a transposed host array) through the pallas
    # artifact: laid out before the program, so its answers are the live
    # predictor's on the contiguous batch. The op itself, which an exported
    # program calls with no wrapper in front, refuses a strided cube on the
    # card with no launch. These calls are checks, not counted in
    # launches_export.
    c, x, v = batch(EXPORT_BATCH)
    strided = torch.from_numpy(c).transpose(1, 2).contiguous().transpose(1, 2)
    live, before = specs["pallas"][0](c, x, v), launch_counts()
    out = arts["pallas"](strided, x, v)
    torch.cuda.synchronize()
    up = rise(before)
    check(up == {k: int(k == "fused_native_score") for k in up},
          f"pallas artifact on a strided batch: launches {up}")
    d_strided = float((live[2] - out[2]).abs().max())
    check(torch.equal(live[0], out[0]) and d_strided <= 1e-6,
          f"pallas artifact on a strided batch != live (proba delta {d_strided})")
    tm = score.native_templates(*specs["pallas"][0]._split_templates(), device=dev)
    before = launch_counts()
    try:
        torch.ops.radarml_torch.native_tables(strided.to(dev, torch.bfloat16), tm.t_xz,
                                              tm.t_yz, tm.t_xy)
    except ValueError as e:
        op_refused = str(e)
    else:
        raise AssertionError("radarml_torch::native_tables took a strided cube")
    check(rise(before) == dict.fromkeys(before, 0), "a refused op launched its kernel")
    say("export", f"pallas artifact on a strided B={EXPORT_BATCH} batch == live (proba "
        f"delta {d_strided:.1e}, B7 +1); radarml_torch::native_tables on a strided cube "
        f"on the card: refused, no launch ({op_refused})")

    # artifact step against live step, inputs on the card (CUDA events)
    steps = {}
    for name, B, inner in (("fused_combo", EXPORT_BATCH, 20), ("svc_exact", SVC_EXPORT_B, 2)):
        p, art = specs[name][0], arts[name]
        c, x, v = batch(B)
        c = (encode_int8_cubes(c, dev).contiguous() if p.cube_dtype == "int8"
             else torch.from_numpy(c).to(dev))
        x, v = torch.from_numpy(x).to(dev), torch.from_numpy(v).to(dev)
        steps[name] = interleaved({"live": lambda p=p: p(c, x, v),
                                   "artifact": lambda art=art: art(c, x, v)},
                                  inner=inner, rounds=5 if inner > 2 else 3)
    say("export", f"on {smi}: step ms (CUDA events, interleaved medians), live vs "
        + "; ".join(f"{k} at B={b}: live {steps[k]['live']:.4f}, artifact "
                    f"{steps[k]['artifact']:.4f}"
                    for k, b in (("fused_combo", EXPORT_BATCH), ("svc_exact", SVC_EXPORT_B)))
        + " (the SVC artifact runs all 100 coupling iterations, the live step stops early)")
    res = {"launches_export": launches, "steps_ms": steps}
    res["serve"] = export_serve(d, smi, classes)
    res["loop"] = closed_loop(d, smi)
    return res


def export_serve(d, smi, classes) -> dict:
    """serve --serving_artifact over the native source, fused at
    --max_batch 128, 8 s, while a thread re-exports an intercept-only model
    with another boosted class 1 s after the first detection: a reload,
    no failed batch, and the labels flip."""
    C, F = len(classes), DEFAULT_ARENA.feature_length
    lin, le, art = (os.path.join(d, f) for f in ("boost.pkl", "boost_le.pkl", "boost.rmlx"))
    common_cli.save_label_encoder(le, LabelEncoder(tuple(classes)))

    def export_boosted(c):
        intercept = np.full((C,), -5.0, np.float32)
        intercept[c] = 5.0
        common_cli.save_model(lin, "linear", coef=np.zeros((C, F), np.float32),
                              intercept=intercept, calib_a=-np.ones((C,), np.float32),
                              calib_b=np.zeros((C,), np.float32), classes=classes)
        out = serve_app.main(["--svm_model", lin, "--label_encoder", le, "--mode", "fused",
                              "--max_batch", str(EXPORT_BATCH), "--export_serving", art])
        check(out == {"exported": art}, f"serve --export_serving returned {out}")

    export_boosted(0)
    grab = DetectionLog()
    rewrite = threading.Timer(1.0, export_boosted, args=(C - 1,))
    grab.on_first = rewrite.start
    serve_log = logging.getLogger("radarml_tpu_torch.apps.serve")
    serve_log.addHandler(grab)
    serve_log.propagate = False
    serve_log.setLevel(logging.INFO)  # the detections, where the package logs warnings only
    before = launch_counts()
    try:
        st = serve_app.main(["--label_encoder", le, "--serving_artifact", art,
                             "--driver", "native", "--max_batch", str(EXPORT_BATCH),
                             "--duration", str(ARTIFACT_SERVE_S), "--min_proba", "0.0",
                             "--reload_poll", "0.2",
                             "--log_detections"])
    finally:
        serve_log.removeHandler(grab)
        serve_log.propagate = True
        serve_log.setLevel(logging.NOTSET)
        if rewrite.is_alive():
            rewrite.join()
    b1 = rise(before)["onepass_tables_combined_i8"]
    names = [row[2] for row in grab.rows]
    check(st["processed"] > 0 and st["predict_errors"] == 0,
          f"artifact serve: processed {st['processed']}, errors {st['predict_errors']}")
    check(st.get("model_reloads", 0) >= 1, f"artifact serve reloads {st.get('model_reloads')}")
    check(classes[0] in names and names[-1] == classes[-1],
          f"labels did not flip from {classes[0]} to {classes[-1]}: first {names[:3]}, "
          f"last {names[-3:]}")
    check(b1 > 0, "the artifact serve loop launched B1 no time")
    say("export", f"on {smi}: serve --serving_artifact (fused combo, batch {EXPORT_BATCH}) "
        f"--driver native {ARTIFACT_SERVE_S} s: processed {st['processed']}, predict_errors 0, "
        f"model_reloads {st['model_reloads']}, labels {classes[0]} -> {classes[-1]} "
        f"({names.index(classes[-1])} detections before the first {classes[-1]}), "
        f"latency_p50_ms {st['latency_p50_ms']}, latency_p95_ms {st['latency_p95_ms']}, "
        f"classify_rate {st['classify_rate']} scans/s, mean_batch {st['mean_batch']}, "
        f"B1 launches {b1}")
    return {"stats": st, "b1": b1}


def closed_loop(d, smi) -> dict:
    """The capture -> retrain -> reload loop of tests/test_closed_loop.py
    at the reference's capture size: 500 samples over the fake-camera gRPC
    path, the SGD family trained on them, served on --grpc_port with
    --reload_poll, then train --online_learn on a second capture; the
    served probabilities change. Then the plots of the capture."""
    import socket

    from radarml_tpu_torch.apps import ground_truth_samples as gts_app
    from radarml_tpu_torch.rpc import RadarServingClient

    real_capture = gts_app.capture_samples
    scans = []

    def counting_capture(radar, get_detections, camera, cfg):  # one poll a scan
        def poll(desired):
            scans[-1] += 1
            return get_detections(desired)

        return real_capture(radar, poll, camera, cfg)

    def capture(name, seed):
        path = os.path.join(d, name)
        scans.append(0)
        gts_app.capture_samples = counting_capture
        t0 = time.perf_counter()
        try:
            n = gts_app.main(["--num_samples", str(N_CAPTURE), "--max_scans",
                              str(CAPTURE_MAX_SCANS), "--dataset", path, "--fake_camera",
                              "--driver_seed", str(seed), "--log_file", ""])
        finally:
            gts_app.capture_samples = real_capture
        check(n == N_CAPTURE, f"captured {n} of {N_CAPTURE} samples")
        return path, f"{n} samples from {scans[-1]} scans in {time.perf_counter() - t0:.2f} s"

    cap1, said1 = capture("captured1.pickle", 9)
    t0 = time.perf_counter()
    train_app.main(["--datasets", cap1, "--grid_epochs", "8", "--folds", "3",
                    *train_args(d, "loop")])
    train_s = time.perf_counter() - t0
    cap2, said2 = capture("captured2.pickle", 10)
    model_path, le_path = os.path.join(d, "loop.pkl"), os.path.join(d, "loop_le.pkl")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    out = {}
    th = threading.Thread(target=lambda: out.update(serve_app.main([
        "--svm_model", model_path, "--label_encoder", le_path, "--grpc_port", str(port),
        "--duration", "30", "--min_proba", "0.0", "--reload_poll", "0.3"])))
    th.start()
    rng = np.random.default_rng(4)
    cube = np.rint(rng.random(DEFAULT_ARENA.grid_shape) * 255).astype(np.float32)
    tgt = [(5.0, 5.0, 100.0)]
    client, deadline = None, time.time() + 15
    while client is None and time.time() < deadline:
        try:
            c = RadarServingClient(f"127.0.0.1:{port}")
            c.classify(cube, tgt)
            client = c
        except Exception:  # the endpoint is still starting
            time.sleep(0.3)
    check(client is not None, "the loop's gRPC endpoint never came up")
    try:
        before = np.asarray(client.classify(cube, tgt)[0].class_probas)
        reloads0 = int(client.get_stats().model_reloads)
        t0 = time.perf_counter()
        train_app.main(["--online_learn", "--datasets", cap2, "--grid_epochs", "3",
                        "--folds", "3", *train_args(d, "loop")])
        online_s = time.perf_counter() - t0
        deadline = time.time() + 10
        while int(client.get_stats().model_reloads) <= reloads0 and time.time() < deadline:
            time.sleep(0.2)
        reloads = int(client.get_stats().model_reloads) - reloads0
        after = np.asarray(client.classify(cube, tgt)[0].class_probas)
    finally:
        client.close()
        th.join(timeout=120)
    check(not th.is_alive() and out.get("grpc_port") == port, "the loop's serve did not end")
    moved = float(np.abs(after - before).max())
    check(reloads >= 1, "the loop's service never reloaded")
    check(moved > 1e-8, f"served probabilities unchanged after the reload ({moved})")
    say("export", f"on {smi}: closed loop: capture 1 {said1}; SGD train app (grid epochs 8, "
        f"3 folds) in {train_s:.2f} s; capture 2 {said2}; served on gRPC with --reload_poll "
        f"0.3; train --online_learn in {online_s:.2f} s; model_reloads +{reloads}; served "
        f"probabilities moved by {moved:.4f} ({before.round(4).tolist()} -> "
        f"{after.round(4).tolist()})")
    return {"capture": [said1, said2], "train_s": train_s, "online_s": online_s,
            "reloads": reloads, "moved": moved, "plots": plots(d, cap1)}


def plots(d, path) -> str:
    """plot_dataset and one DatasetBrowser page of a captured set, to PNG
    with the Agg backend, where matplotlib imports."""
    try:
        import matplotlib
    except ImportError as e:
        say("export", f"plots skipped: {e.name} not installed")
        return f"skipped: {e.name} not installed"
    matplotlib.use("Agg")
    from radarml_tpu_torch.viz import DatasetBrowser, plot_dataset

    data = load_datasets([path])
    names = sorted(set(data["labels"]))
    feats = np.stack([np.asarray(s[2], np.float32).ravel() for s in data["samples"]]) / RADAR_MAX
    y = np.array([names.index(n) for n in data["labels"]])
    figs = plot_dataset(feats, y, names)
    pngs = [os.path.join(d, "dataset.png"), os.path.join(d, "browser.png")]
    figs[0].savefig(pngs[0])
    DatasetBrowser(data["samples"], data["labels"]).fig.savefig(pngs[1])
    sizes = [os.path.getsize(p) for p in pngs]
    check(all(s > 0 for s in sizes), "an empty PNG")
    say("export", f"plots: plot_dataset ({len(figs)} figures; xy planes) and a DatasetBrowser "
        f"page to PNG, {sizes} bytes")
    return "rendered"


# -- phase 15: multi-device ---------------------------------------------------

# Phase 15's cuts (PERF.md section 4): the serving calls at phase 6's batch,
# the CNN's at 512 scans (2,048 views at 80x80); the SGD grid's epochs
# capped at 12 (the walks run up to 300), the dnn app 3 epochs (of 100), the
# SGAN 2 fused steps. The ranks read these from the run's mesh.json.
MESH_CFG = {"scans": BIG, "neural_scans": 512, "grid_epochs": 12, "dnn_epochs": 3,
            "sgan_steps": 2, "cell_samples": 1881, "device": "cuda"}
MESH_RANK_TIMEOUT = 480
MESH_FOLD_EPOCHS = 4  # the fold walks' check: a parted fold shows in the first epoch
# The dnn app under cuDNN's deterministic algorithms, so that one device
# repeats itself bit for bit; with MESH_DROP_GRAD_SUM=1 the control run
# whose ranks skip the gradient sums (a wrong data-parallel step, which the
# bars must reject). Written into phase 15's directory and run there.
DNN_LAUNCHER = """import os, runpy, sys
import torch
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
if os.environ.get("MESH_DROP_GRAD_SUM") == "1":
    from radarml_tpu_torch.train import trainer
    trainer.all_reduce_grads = lambda mesh, params: None
sys.argv[0] = "dnn"
runpy.run_module("radarml_tpu_torch.apps.dnn", run_name="__main__", alter_sys=True)
"""
# A sharded SVC call against the whole batch's: each rank's half takes
# another cuBLAS algorithm for the pair product (2.05e-05 on an NVIDIA
# H100 80GB HBM3 at 700 W; PERF.md section 6); its decisions are compared
# where the top-2 margin exceeds it.
MESH_SVC_ATOL = 1e-4
MESH_SGD_GROUP = [{"alpha": [10.0e-04, 10.0e-05, 10.0e-06, 10.0e-07], "penalty": ["l2"],
                   "average": [False]}]  # one penalty group of the reference grid
MESH_TAILS = ("lookup", "glookup", "combo", "sel", "sel3")


def mesh_serving_inputs(d, n_scans):
    """The demo model's scans (phase 4's, tiled to n_scans) as uint8."""
    g = dict(np.load(ASSET))
    cubes, targets = make_scan_batch(N_SLICE, seed=int(g["scan_seed"]))
    xyz, valid = pad_targets([[(t.x, t.y, t.z)] for t in targets], max_targets=4)
    reps = -(-n_scans // N_SLICE)
    return (np.tile(np.rint(cubes).astype(np.uint8), (reps, 1, 1, 1))[:n_scans],
            np.tile(xyz, (reps, 1, 1))[:n_scans], np.tile(valid, (reps, 1))[:n_scans])


def mesh_predictors(d, dev, mesh):
    """Every mode's predictor of phase 15: name -> (predictor, scans)."""
    from radarml_tpu_torch.models.cnn import init_cnn

    g = dict(np.load(ASSET))
    model, calib = from_numpy(g["coef"], g["intercept"], g["calib_a"], g["calib_b"],
                              device=dev)
    kw = dict(train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA, model=model,
              calibration=calib, min_proba=float(g["min_proba"]), device=dev, mesh=mesh)
    B, Bn = MESH_CFG["scans"], MESH_CFG["neural_scans"]
    preds = {f"fused_{t}": (RadarPredictor(mode="fused", fused_tail=t, **kw), B)
             for t in MESH_TAILS}
    preds["fused_combo_single"] = (RadarPredictor(mode="fused", fused_quant="single", **kw), B)
    preds["pallas"] = (RadarPredictor(mode="pallas", cube_dtype="bfloat16", **kw), B)
    preds["fast_int8"] = (RadarPredictor(mode="fast", cube_dtype="int8", **kw), B)
    preds["exact"] = (RadarPredictor(mode="exact", **kw), B)
    s = dict(np.load(os.path.join(d, "svc.npz")))
    svc_model = svc.SVCModel(
        support_vectors=torch.as_tensor(s["sv"], device=dev),
        dual_coef=torch.as_tensor(s["dual_coef"], device=dev),
        intercept=torch.as_tensor(s["intercept"], device=dev),
        n_support=tuple(int(v) for v in s["n_support"]), kernel="rbf",
        gamma=float(s["gamma"]), probA=torch.as_tensor(s["probA"], device=dev),
        probB=torch.as_tensor(s["probB"], device=dev))
    preds["svc_exact"] = (RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, svc_model,
                                         min_proba=float(s["min_proba"]), mode="exact",
                                         device=dev, mesh=mesh), B)
    cnn = common_cli.neural_classifier(init_cnn(3, (80, 80), seed=1234, device=dev),
                                       (80, 80), dev)
    preds["cnn"] = (RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, cnn, min_proba=0.4,
                                   mode="exact", device=dev, mesh=mesh), Bn)
    return preds


def step_ms(fn, reps: int = 5) -> float:
    """Median host ms of fn() to completion (synchronized), after a warm-up."""
    fn()
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def mesh_sgan_run(dev, mesh, nudge: int = 0):
    """MESH_CFG["sgan_steps"] fused steps at 128x128 (n_batch 32) from
    seeded weights (each moved one float32 ulp up or down with `nudge`
    +1 / -1), views and draws: the losses of each step and a digest of
    every parameter and statistic after them."""
    import hashlib

    from radarml_tpu_torch.train import sgan_trainer as st
    from radarml_tpu_torch.train.trainer import seeded_generator

    cfg = st.SGANConfig(n_classes=3)
    gen, disc, state = st.sgan_init(cfg, (128, 128), device=dev)
    if nudge:
        with torch.no_grad():
            for p in (*gen.parameters(), *disc.parameters()):
                p.copy_(torch.nextafter(p, torch.full_like(p, nudge * float("inf"))))
    step = st.make_sgan_step(gen, disc, cfg, mesh=mesh)
    rng = torch.Generator(device=dev).manual_seed(5)
    losses, times = [], []
    for i in range(MESH_CFG["sgan_steps"]):
        sv = torch.rand((16, 128, 128, 3), generator=rng, device=dev) * 2 - 1
        sl = torch.randint(0, 3, (16,), generator=rng, device=dev)
        rv = torch.rand((16, 128, 128, 3), generator=rng, device=dev) * 2 - 1
        draws = st.draw_step(cfg, 16, disc, seeded_generator(dev, cfg.seed, i))
        t0 = time.perf_counter()
        state, out = step(state, sv, sl, rv, draws)
        losses.append({k: float(v) for k, v in out.items()})
        times.append((time.perf_counter() - t0) * 1e3)
    h = hashlib.sha256()
    for net in (gen, disc):
        for t in net.state_dict().values():
            h.update(t.detach().cpu().numpy().tobytes())
    return {"losses": losses, "digest": h.hexdigest(), "ms": times}


def mesh_grids(d, dev, mesh):
    """The SGD grid's l2 group and the SVC reference grid on the train
    cell's features, sharded over `mesh` (or not): split scores, best
    parameters, seconds."""
    from radarml_tpu_torch.train.gridsearch import SVC_PARAM_GRID, grid_search_sgd, \
        grid_search_svc

    t = dict(np.load(os.path.join(d, "train_cell.npz")))
    X = torch.as_tensor(t["X"], device=dev)
    out = {}
    for name, run in (
            ("sgd", lambda: grid_search_sgd(X, t["y"], folds=5, grid=MESH_SGD_GROUP,
                                            epochs=MESH_CFG["grid_epochs"], mesh=mesh)),
            ("svc", lambda: grid_search_svc(X, t["y"], folds=5, grid=SVC_PARAM_GRID,
                                            probability=False, mesh=mesh))):
        t0 = time.perf_counter()
        res = run()
        out[name] = {"scores": [r["split_scores"] for r in res.cv_results],
                     "best": {k: str(v) for k, v in res.best_params.items()},
                     "s": time.perf_counter() - t0}
    return out


def mesh_fold_walks(X, y, dev) -> bool:
    """Whether each fold walked alone equals the same fold in the 5-fold
    stack, and a 3-fold stack its slice of it (the stacks of one rank and
    of two), bit for bit."""
    from radarml_tpu_torch.train.gridsearch import stratified_kfold_indices

    splits = stratified_kfold_indices(y, 5)
    n_tr = min(len(tr) for tr, _ in splits)
    Xs = torch.stack([X[torch.as_tensor(tr[:n_tr], device=dev)] for tr, _ in splits])
    ys = np.stack([y[tr[:n_tr]] for tr, _ in splits])
    kw = dict(n_classes=3, penalty="l2", average=False, alphas=[1e-3, 1e-4],
              l1_ratios=[0.0, 0.0], epochs=MESH_FOLD_EPOCHS, tol=1e-3)
    five = linear.sgd_fit_many_folds(Xs, ys, **kw)
    three = linear.sgd_fit_many_folds(Xs[2:5], ys[2:5], **kw)
    same = all(torch.equal(a[2:5], c) for a, c in zip(five, three))
    for f in range(5):
        alone = linear.sgd_fit_many_folds(Xs[f:f + 1], ys[f:f + 1], **kw)
        same &= all(torch.equal(a[f], b[0]) for a, b in zip(five, alone))
    return same


def dnn_nudged_histories(ds, dev) -> list:
    """The dnn app's flow on one device (its preprocessing, weights and
    schedule) from weights one float32 ulp up and down: two histories."""
    from radarml_tpu_torch.data.preprocess import preprocess_multiview
    from radarml_tpu_torch.models.cnn import RESCALE, init_cnn
    from radarml_tpu_torch.train.trainer import TrainConfig, train_cnn

    data = load_datasets([ds])
    samples, labels = filter_samples(data["samples"], data["labels"],
                                     ["person", "dog", "cat", "pet"])
    pre = preprocess_multiview(samples, labels, rescale=RESCALE, train_split=0.8,
                               device=dev)
    out = []
    for nudge in (1, -1):
        model = init_cnn(pre["n_classes"], RESCALE, seed=1234, device=dev)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.nextafter(p, torch.full_like(p, nudge * float("inf"))))
        _, hist = train_cnn(model, pre["X_train"], pre["y_train"], pre["X_val"], pre["y_val"],
                            w_classes=pre["w_classes"],
                            config=TrainConfig(epochs=MESH_CFG["dnn_epochs"]))
        out.append(hist)
    return out


def mesh_rank(argv) -> None:
    """One rank of a phase-15 group: python3 chip_smoke.py --mesh-rank GROUP DIR."""
    from radarml_tpu_torch.parallel import mesh as pmesh
    from radarml_tpu_torch.parallel.train_step import make_dp_sgd_train_step

    group, d = argv
    MESH_CFG.update(json.load(open(os.path.join(d, "mesh.json"))))
    logging.getLogger("radarml_tpu_torch").setLevel(logging.WARNING)
    on_cpu = MESH_CFG["device"] == "cpu"
    if group == "one":  # a one-rank group on an explicit address
        port = os.environ["MASTER_PORT"]
        pmesh.init_distributed(f"127.0.0.1:{port}", 1, 0, device="cpu" if on_cpu else None)
    else:  # torchrun's environment
        pmesh.init_distributed(device="cpu" if on_cpu else None)
    mesh = pmesh.make_mesh()
    dev = mesh.device
    rep = {"rank": mesh.rank, "backend": mesh.backend, "device": str(dev),
           "group": group, "world": mesh.size}
    t_start = time.perf_counter()
    if group == "one":
        rng = torch.Generator(device=dev).manual_seed(3)
        X = torch.rand((512, DEFAULT_ARENA.feature_length), generator=rng, device=dev)
        y = torch.randint(0, 3, (512,), generator=rng, device=dev)
        runs = []
        for m in (None, mesh):
            params = {"coef": torch.zeros((3, X.shape[1]), device=dev),
                      "intercept": torch.zeros(3, device=dev)}
            step = make_dp_sgd_train_step(m, 3, lr=0.5, weight_decay=1e-4)
            for _ in range(3):
                params, loss = step(params, X, y)
            runs.append((params, loss))
        (a, la), (b, lb) = runs
        rep["dp_step_equal"] = bool(torch.equal(a["coef"], b["coef"])
                                    and torch.equal(a["intercept"], b["intercept"])
                                    and torch.equal(la, lb))
        cubes, xyz, valid = mesh_serving_inputs(d, MESH_CFG["scans"])
        g = dict(np.load(ASSET))
        model, calib = from_numpy(g["coef"], g["intercept"], g["calib_a"], g["calib_b"],
                                  device=dev)
        kw = dict(train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA, model=model,
                  calibration=calib, min_proba=float(g["min_proba"]), device=dev)
        outs = [RadarPredictor(mode="fused", mesh=m, **kw)(cubes, xyz, valid)
                for m in (None, mesh)]
        rep["fused_equal"] = all(torch.equal(p, q) for p, q in zip(*outs))
    else:
        res, counts, ms, parts = {}, {}, {}, {}
        t0 = time.perf_counter()
        cubes, xyz, valid = mesh_serving_inputs(d, MESH_CFG["scans"])
        resident = [torch.as_tensor(a).to(dev) for a in (cubes, xyz, valid)]
        for name, (pred, B) in mesh_predictors(d, dev, mesh).items():
            before = launch_counts()
            out = pred(cubes[:B], xyz[:B], valid[:B])
            counts[name] = rise(before)
            res.update({f"{name}.{k}": o.cpu().numpy()
                        for k, o in zip(("pred", "best", "proba"), out)})
            if name in ("fused_combo", "pallas", "exact"):  # inputs on the card
                ms[name] = step_ms(lambda: pred(*(t[:B] for t in resident)))
        np.savez(os.path.join(d, f"serve_r{mesh.rank}.npz"), **res)
        parts["serving"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep["grids"] = mesh_grids(d, dev, mesh)
        parts["grids"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        from radarml_tpu_torch.train import sgan_trainer

        with deterministic_cudnn():
            rep["sgan"] = mesh_sgan_run(dev, mesh)
            # the control: the same steps with the gradient sums skipped
            reduce_grads = sgan_trainer.all_reduce_grads
            sgan_trainer.all_reduce_grads = lambda mesh, params: None
            try:
                rep["sgan_nosum"] = mesh_sgan_run(dev, mesh)
            finally:
                sgan_trainer.all_reduce_grads = reduce_grads
        parts["sgan"] = time.perf_counter() - t0
        rep.update(counts=counts, ms=ms, s_parts=parts)
    rep["s"] = time.perf_counter() - t_start
    print(json.dumps(rep), flush=True)
    pmesh.close_distributed()


def mesh_group(d, group: str, n: int) -> list:
    """Run `n` ranks of `group` (this script with --mesh-rank) and return
    their reports (run_ranks returns only when every rank exited 0)."""
    from radarml_tpu_torch.parallel.spawn import run_ranks

    outs = run_ranks([sys.executable, os.path.abspath(__file__), "--mesh-rank", group, d],
                     n, MESH_RANK_TIMEOUT, cwd=HERE)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def phase_mesh(dev, smi, svc_model) -> dict:
    with tempfile.TemporaryDirectory(dir=HERE, prefix="_mesh") as d:
        return mesh_in(d, dev, smi, svc_model)


def mesh_data(d, dev, svc_model):
    """Phase 15's inputs in `d`: the SVC (svc.npz), the train cell's
    features (train_cell.npz: make_dataset(2280, hardness 1.0) scaled as
    the train app scales it, its first 1,881 samples, the size of the
    app's balanced training split, all 10,010 features) and the same
    samples as the dnn app's dataset. Returns (dataset path, X, y)."""
    gs = dict(np.load(SVC_ASSET))
    np.savez(os.path.join(d, "svc.npz"), sv=svc_model.support_vectors.cpu().numpy(),
             dual_coef=svc_model.dual_coef.cpu().numpy(),
             intercept=svc_model.intercept.cpu().numpy(),
             n_support=np.asarray(svc_model.n_support), gamma=svc_model.gamma,
             probA=svc_model.probA.cpu().numpy(), probB=svc_model.probB.cpu().numpy(),
             min_proba=float(gs["min_proba"]))
    samples, labels = make_dataset(N_TRAIN, seed=1234, hardness=TRAIN_HARDNESS)
    ds = os.path.join(d, "dnn.pickle")
    save_dataset(ds, samples, labels, append=False)
    n_cell = MESH_CFG["cell_samples"]
    scaled = [tuple(np.asarray(p) / RADAR_MAX for p in s) for s in samples[:n_cell]]
    _, y = LabelEncoder.fit_transform(labels[:n_cell])
    X = process_samples(scaled, device=dev)
    np.savez(os.path.join(d, "train_cell.npz"), X=X.cpu().numpy(), y=np.asarray(y))
    return ds, X, np.asarray(y)


def mesh_in(d, dev, smi, svc_model) -> dict:
    import pickle

    logging.getLogger("radarml_tpu_torch").setLevel(logging.WARNING)
    t_phase = t0 = time.perf_counter()
    json.dump(MESH_CFG, open(os.path.join(d, "mesh.json"), "w"))
    n_cell = MESH_CFG["cell_samples"]
    # a. one rank on its own group (NCCL on the card), while the data is made
    with ThreadPoolExecutor(1) as pool:
        one_future = pool.submit(mesh_group, d, "one", 1)
        ds, X_cell, y_cell = mesh_data(d, dev, svc_model)
        res = {"cuts": dict(MESH_CFG), "s_data": time.perf_counter() - t0}
        one = one_future.result()[0]
    res["one"] = dict(one, s_group=time.perf_counter() - t0)
    say("mesh", f"on {smi}: one rank, backend {one['backend']} on {one['device']}: "
        f"make_dp_sgd_train_step (512 x {DEFAULT_ARENA.feature_length}, 3 steps) and the fused "
        f"combo predictor (B={MESH_CFG['scans']}) on make_mesh(1) against mesh=None: "
        f"{one['dp_step_equal']} / {one['fused_equal']} bit-equal; {one['s']:.1f} s in the "
        f"rank; {res['one']['s_group']:.1f} s for it and the data (made in "
        f"{res['s_data']:.1f} s); the rank left its group and exited 0")
    check(one["dp_step_equal"], "the dp step on a one-rank mesh differs from no mesh")
    check(one["fused_equal"], "the fused predictor on a one-rank mesh differs from no mesh")

    # b. two ranks sharing the card: serving, both grids, the SGAN steps;
    # meanwhile this process runs the one-device controls: the grids, the
    # fold walks, the dnn flow from weights one ulp up and down and the
    # SGAN steps (so the seconds of either side are no speed)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        two_future = pool.submit(mesh_group, d, "two", 2)
        grids = mesh_grids(d, dev, None)
        fold_equal = mesh_fold_walks(X_cell, y_cell, dev)
        with deterministic_cudnn():
            nudged_dnn = dnn_nudged_histories(ds, dev)
            sg = [mesh_sgan_run(dev, None) for _ in range(2)]
            nudged = [mesh_sgan_run(dev, None, nudge=n) for n in (1, -1)]
        two = two_future.result()
    two_s = time.perf_counter() - t0
    r0, r1 = (dict(np.load(os.path.join(d, f"serve_r{r}.npz"))) for r in range(2))
    for k in r0:
        check(np.array_equal(r0[k], r1[k]), f"ranks returned different {k}")
    cubes, xyz, valid = mesh_serving_inputs(d, MESH_CFG["scans"])
    resident = [torch.as_tensor(a).to(dev) for a in (cubes, xyz, valid)]
    serve = {}
    for name, (pred, B) in mesh_predictors(d, dev, None).items():
        want = [o.cpu().numpy() for o in pred(cubes[:B], xyz[:B], valid[:B])]
        half, parts = B // 2, []
        for lo in (0, B // 2):  # each rank's shard, alone on one device
            before = launch_counts()
            parts.append([o.cpu().numpy() for o in pred(cubes[lo:lo + half],
                                                         xyz[lo:lo + half],
                                                         valid[lo:lo + half])])
            expect = {k: v for k, v in rise(before).items() if v}
        got = [r0[f"{name}.{k}"] for k in ("pred", "best", "proba")]
        check(all(np.array_equal(g_, np.concatenate(p_)) for g_, p_ in zip(got, zip(*parts))),
              f"sharded {name} differs from the single-device calls on its shards")
        err = float(np.abs(got[2] - want[2]).max())
        if name.startswith("fused"):
            check(all(np.array_equal(a, b) for a, b in zip(got, want)),
                  f"sharded {name} not bit-equal to the whole batch's call")
        else:  # against the whole batch's call
            tol, ok = 1e-6, np.ones(want[0].shape, bool)
            if name == "svc_exact":  # its pair product's cuBLAS algorithm moves with B
                tol = MESH_SVC_ATOL
                minp = float(np.load(os.path.join(d, "svc.npz"))["min_proba"])
                ok = margin_ok(want[2], want[1], minp, tol)
            check(np.array_equal(got[0][ok], want[0][ok]), f"sharded {name} decisions differ")
            check(err <= tol, f"sharded {name} proba {err} > {tol}")
        for rep in two:
            moved = {k: v for k, v in rep["counts"][name].items() if v}
            check(moved == expect, f"rank {rep['rank']} {name} launches {moved} != {expect}")
        serve[name] = {"max_abs_err": err, "launches_per_rank": expect}
        if name in two[0]["ms"]:
            serve[name]["ms_sharded"] = [rep["ms"][name] for rep in two]
            serve[name]["ms_single"] = step_ms(lambda: pred(*(t[:B] for t in resident)))
    res["serve"] = serve
    res["two"] = [{k: rep[k] for k in ("rank", "backend", "device", "s", "s_parts", "ms")}
                  for rep in two]
    say("mesh", f"on {smi}: two ranks sharing {two[0]['device']}, backend {two[0]['backend']} "
        f"(ranks on {two[0]['device']} / {two[1]['device']}, each left the group and exited 0"
        f"; {two_s:.1f} s with their start "
        "and this process's one-device controls beside them; in rank 0: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in two[0]["s_parts"].items())
        + f"): sharded serving B={MESH_CFG['scans']} x 4 slots, each rank's half bit-equal to "
        "one device on it; fused x5 tails + combo single bit-equal to the whole batch's call, "
        f"pallas bf16 / fast int8 / exact / SVC exact / CNN (B={MESH_CFG['neural_scans']}) "
        "decisions equal, proba within " + ", ".join(
            f"{k} {v['max_abs_err']:.1e}" for k, v in serve.items() if not k.startswith("fused"))
        + "; each rank's kernel launches == one call on its shard; a step, sharded (rank 0 / 1,"
        " beside the controls) against one device (alone): " + ", ".join(
            f"{k} {v['ms_sharded'][0]:.2f} / {v['ms_sharded'][1]:.2f} vs {v['ms_single']:.2f} ms"
            for k, v in serve.items() if "ms_sharded" in v))

    for name, g1 in grids.items():
        g2 = two[0]["grids"][name]
        g1["s_sharded"] = g2["s"]
        g1["max_abs_err"] = float(np.abs(np.asarray(g2["scores"])
                                         - np.asarray(g1["scores"])).max())
    res["grids"] = grids
    say("mesh", f"on {smi}: SGD grid (l2 group, 4 alphas, 5 folds, {MESH_CFG['grid_epochs']} "
        f"epochs, {n_cell} x {DEFAULT_ARENA.feature_length}) split scores max delta "
        f"{grids['sgd']['max_abs_err']}, sharded {grids['sgd']['s_sharded']:.1f} s; SVC grid "
        f"(30 candidates, 5 folds) best {grids['svc']['best']} / "
        f"{two[0]['grids']['svc']['best']}, scores within {grids['svc']['max_abs_err']:.1e}, "
        f"sharded {grids['svc']['s_sharded']:.1f} s; each fold walked alone == the same fold in "
        f"the 5-fold stack, a 3-fold stack == its slice ({MESH_FOLD_EPOCHS} epochs): "
        f"{fold_equal}")
    for name, g1 in grids.items():
        g2 = two[0]["grids"][name]
        check(two[1]["grids"][name]["scores"] == g2["scores"], f"{name} grid ranks differ")
        check(g2["best"] == g1["best"], f"sharded {name} grid best {g2['best']} != {g1['best']}")
        if name == "sgd":
            check(g2["scores"] == g1["scores"], "sharded SGD grid split scores differ")
        else:
            check(g1["max_abs_err"] <= 1e-6, f"sharded SVC grid scores {g1['max_abs_err']} > 1e-6")
    check(fold_equal, "a fold walked alone differs from the same fold in a stack")

    # c. the dnn app under torchrun against --mesh 0 run twice, all under
    # cuDNN's deterministic algorithms, with the control run whose ranks
    # skip the gradient sums; the four runs share the card at once
    t0 = time.perf_counter()
    launcher = os.path.join(d, "dnn_launcher.py")
    with open(launcher, "w") as f:
        f.write(DNN_LAUNCHER)
    common = ["--datasets", ds, "--epochs", str(MESH_CFG["dnn_epochs"])]
    if MESH_CFG["device"] == "cpu":
        common += ["--platform", "cpu"]

    def torchrun():
        return ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                launcher, "--mesh", "2"]

    runs = {"dnn2": torchrun(), "dnn2_nosum": torchrun(), "dnn0_0": [launcher],
            "dnn0_1": [launcher]}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([HERE, os.environ.get("PYTHONPATH", "")]))
    procs, logs = {}, {}
    try:
        for k, v in runs.items():
            with open(os.path.join(d, f"{k}.out"), "w") as out:
                procs[k] = subprocess.Popen(
                    [sys.executable, *v, "--results_dir", os.path.join(d, k)] + common,
                    cwd=d, env=dict(env, MESH_DROP_GRAD_SUM=str(int(k == "dnn2_nosum"))),
                    stdout=out, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + MESH_RANK_TIMEOUT
        for k, p in procs.items():
            p.wait(timeout=max(deadline - time.monotonic(), 1))
            logs[k] = open(os.path.join(d, f"{k}.out")).read()
            check(p.returncode == 0, f"{k} failed:\n{logs[k][-3000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    say("mesh", "dnn runs' exit codes (the torchrun runs' ranks leave their group at exit): "
        + ", ".join(f"{k} {p.returncode}" for k, p in procs.items()))
    hists = {}
    for k in runs:
        with open(os.path.join(d, k, "c_model.pickle"), "rb") as f:
            hists[k] = pickle.load(f)["history"]
    hist2, h1, h2 = hists["dnn2"], hists["dnn0_0"], hists["dnn0_1"]

    def digests(k):
        return [ln.rsplit(" ", 1)[1] for ln in logs[k].splitlines()
                if "parameters sha256" in ln]

    def dnn_misses(h) -> list:
        """The (key, epoch, value, bar) where `h` leaves the bars: the first
        epoch's loss within rtol 1e-4 of one device's, the rest within twice
        one device's spread (its second run, its runs from weights one ulp
        up and down)."""
        out = []
        for key in ("loss", "val_loss"):
            for e, (a, b) in enumerate(zip(h[key], h1[key])):
                spread = max(abs(o[key][e] - b) for o in (h2, *nudged_dnn))
                bar = 1e-4 * abs(b) if key == "loss" and e == 0 else 2 * spread
                if abs(a - b) > bar:
                    out.append((key, e + 1, a, b, bar))
        return out

    misses, control = dnn_misses(hist2), dnn_misses(hists["dnn2_nosum"])
    res["dnn"] = {"loss_mesh": hist2["loss"], "loss_single": [h1["loss"], h2["loss"]],
                  "val_loss_mesh": hist2["val_loss"],
                  "val_loss_single": [h1["val_loss"], h2["val_loss"]],
                  "nudged": nudged_dnn, "nosum": hists["dnn2_nosum"],
                  "nosum_misses": control}

    def fmt(h, key):
        return ", ".join(f"{v:.7f}" for v in h[key])

    say("mesh", f"on {smi}: dnn --mesh 2 under torchrun ({MESH_CFG['dnn_epochs']} epochs, "
        f"make_dataset({N_TRAIN}), cuDNN deterministic): loss {fmt(hist2, 'loss')} vs --mesh 0 "
        f"{fmt(h1, 'loss')} / {fmt(h2, 'loss')}, one device from weights one ulp up / down "
        + " / ".join(fmt(h, "loss") for h in nudged_dnn) + f"; val loss "
        f"{fmt(hist2, 'val_loss')} vs {fmt(h1, 'val_loss')} / {fmt(h2, 'val_loss')} / "
        + " / ".join(fmt(h, "val_loss") for h in nudged_dnn) + "; the ranks' parameter digests "
        f"{'equal' if len(set(digests('dnn2'))) == 1 and len(digests('dnn2')) == 2 else digests('dnn2')}"
        f"; the control without gradient sums: loss {fmt(hists['dnn2_nosum'], 'loss')}, val "
        f"loss {fmt(hists['dnn2_nosum'], 'val_loss')}, outside the bars at "
        + (", ".join(f"{k} epoch {e} ({a:.7f} vs {b:.7f}, bar {bar:.1e})"
                     for k, e, a, b, bar in control) or "none")
        + f"; {time.perf_counter() - t0:.1f} s for this part")
    dg = digests("dnn2")
    check(len(dg) == 2 and dg[0] == dg[1], f"the ranks' parameters differ: {dg}")
    check(not misses, "dnn --mesh 2 outside the bars (key, epoch, value, one device's, bar): "
          f"{misses}")
    check(bool(control), "the bars pass a dnn run without gradient sums")

    # d. the SGAN steps: the ranks' against one device run twice and from
    # weights one ulp up and down (all under cuDNN's deterministic
    # algorithms), and the ranks' control without gradient sums
    def sgan_misses(run) -> list:
        out = []
        for s, (a, b) in enumerate(zip(run["losses"], sg[0]["losses"])):
            for k in a:
                spread = max(abs(o["losses"][s][k] - b[k]) for o in (sg[1], *nudged))
                bar = 1e-4 * abs(b[k]) if s == 0 else max(2 * spread, 1e-4 * abs(b[k]))
                if abs(a[k] - b[k]) > bar:
                    out.append((k, s + 1, a[k], b[k], bar))
        return out

    sharded, nosum = two[0]["sgan"], two[0]["sgan_nosum"]
    misses, control = sgan_misses(sharded), sgan_misses(nosum)
    res["sgan"] = {"sharded": sharded, "single": sg, "nudged": nudged, "nosum": nosum,
                   "nosum_misses": control}
    say("mesh", f"on {smi}: SGAN 128x128, {MESH_CFG['sgan_steps']} fused steps (n_batch 32, "
        "cuDNN deterministic): losses sharded / one device / one device again / one ulp up / "
        "down / the control without gradient sums: " + "; ".join(
            f"step {s + 1} " + ", ".join(
                f"{k} " + " / ".join(f"{r['losses'][s][k]:.6f}"
                                     for r in (sharded, *sg, *nudged, nosum))
                for k in ("c_loss", "d_real", "d_fake", "gan"))
            for s in range(MESH_CFG["sgan_steps"]))
        + "; the control outside the bars at " + (", ".join(
            f"{k} step {s} ({a:.6f} vs {b:.6f}, bar {bar:.1e})" for k, s, a, b, bar in control)
            or "none")
        + "; step ms sharded " + ", ".join(f"{v:.1f}" for v in sharded["ms"])
        + " vs one device " + ", ".join(f"{v:.1f}" for v in sg[0]["ms"]))
    check(sharded["digest"] == two[1]["sgan"]["digest"], "the ranks' SGAN states differ")
    check(not misses, "sharded SGAN outside the bars (key, step, value, one device's, bar): "
          f"{misses}")
    check(bool(control), "the bars pass SGAN steps without gradient sums")
    res["launches_mesh"] = {
        k: [rep["counts"][name][k] for rep in two]
        for name, k in [(f"fused_{t}", FUSED_KERNEL[t]) for t in MESH_TAILS]
        + [("pallas", "fused_native_score"), ("svc_exact", "rbf_gram")]}
    res["s"] = time.perf_counter() - t_phase
    say("mesh", f"phase 15 in {res['s']:.1f} s")
    return res


# -- phase 16: the reference's sklearn pickles --------------------------------

REF_DIR = os.path.join(HERE, "radarml_tpu_torch", "assets", "reference_pickles")
# The JAX package's bar for a reference pickle served through the
# predictor (tests/test_reference_parity.py:93-94), the fused-against-fast
# int8 bar of phase 4, and the SVC golden bar (SVC_PROBA_ATOL).
REF_LINEAR_ATOL, REF_FUSED_ATOL = 5e-5, 1e-6
REF_MODES = ("exact", "fast_i8", "pallas", "fused_combo", "fused_lookup", "fused_glookup",
             "fused_sel", "fused_sel3", "svc_exact")
# The predict app in a process of its own: its results and whether any
# sklearn module was imported, as one JSON line.
PREDICT_CHILD = """import json, sys
from radarml_tpu_torch.apps import predict
res = predict.main(sys.argv[1:])
print(json.dumps({"results": res,
                  "sklearn": sorted(m for m in sys.modules if m.split(".")[0] == "sklearn")}))
"""


def sklearn_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] == "sklearn")


def phase_reference(dev, smi) -> dict:
    """Phase 16: the reference's sklearn pickles served on the card, with
    the predict app's files in a temporary directory."""
    with tempfile.TemporaryDirectory() as d:
        return reference_in(d, dev, smi)


def reference_in(d, dev, smi) -> dict:
    t_phase = time.perf_counter()
    path = {n: os.path.join(REF_DIR, f"{n}.pickle")
            for n in ("svm_radar_classifier", "svc_radar_classifier", "radar_labels")}
    check(not sklearn_modules(), f"sklearn modules before phase 16: {sklearn_modules()}")
    model, calib = common_cli.load_model(path["svm_radar_classifier"], device=dev)
    svc_model, none = common_cli.load_model(path["svc_radar_classifier"], device=dev)
    classes = list(common_cli.load_label_encoder(path["radar_labels"]).classes_)
    check(none is None and calib is not None and not sklearn_modules(),
          f"loading the reference pickles imported {sklearn_modules()}")
    with np.load(os.path.join(REF_DIR, "expected.npz")) as f:
        e = {k: f[k] for k in f.files}
    check(classes == [str(c) for c in e["classes"]], "the label encoder's classes")
    n = int(e["n_scans"])
    cubes, targets = make_scan_batch(n, seed=int(e["scan_seed"]))
    cubes = np.rint(cubes)
    xyz, valid = pad_targets([[(t.x, t.y, t.z)] for t in targets], max_targets=4)
    check(np.array_equal(xyz[:, 0], e["targets_xyz"]), "expected.npz's targets")
    kw = dict(train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA, model=model,
              calibration=calib, min_proba=0.0, device=dev)
    preds = {"exact": RadarPredictor(mode="exact", **kw),
             "fast_i8": RadarPredictor(mode="fast", cube_dtype="int8", **kw),
             "pallas": RadarPredictor(mode="pallas", cube_dtype="bfloat16", **kw)}
    for tail in ("combo", "lookup", "glookup", "sel", "sel3"):
        preds[f"fused_{tail}"] = RadarPredictor(mode="fused", fused_tail=tail, **kw)
    preds["svc_exact"] = RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, svc_model,
                                        min_proba=0.0, mode="exact", device=dev)
    xyz_d, valid_d = torch.from_numpy(xyz).to(dev), torch.from_numpy(valid).to(dev)
    src = {}
    for name, p in preds.items():
        if p.mode == "fused":
            src[name] = p.pack_host(cubes.astype(np.uint8)).to(dev)
        elif p.mode == "pallas":
            src[name] = p.encode_host(cubes).to(dev)
        else:
            src[name] = torch.from_numpy(cubes.astype(np.float32)).to(dev)

    # a. the main path: one call a predictor, every kernel counted
    before = launch_counts()
    out = {}
    for name in REF_MODES:
        res = preds[name](src[name], xyz_d, valid_d)
        check(all(r.device.type == dev.type for r in res), f"{name} left the card")
        out[name] = [r.cpu().numpy() for r in res]
    launched = rise(before)
    want_launches = {"onepass_tables_combined_i8": 1, "onepass_tables_i8": 1,
                     "onepass_tables_grouped_i8": 1, "onepass_tables_sel_i8": 1,
                     "onepass_scores_i8": 1, "fused_native_score": 1, "rbf_gram": 1}
    check(launched == want_launches, f"phase 16 launches {launched}, expected {want_launches}")

    # b. against sklearn (expected.npz) and against each other
    err = {}
    for name, (pr, best, proba) in out.items():
        check(pr.shape == (n, 4) and proba.shape == (n, 4, 3) and np.isfinite(proba).all(),
              f"{name} shapes / finite")
        check((pr[:, 1:] == -1).all(), f"{name} padded slots not UNKNOWN")
        ref = e["svc_proba" if name == "svc_exact" else "linear_proba"]
        err[name] = float(np.abs(proba[:, 0] - ref).max())
    for name in REF_MODES[:-1]:
        check(err[name] <= REF_LINEAR_ATOL,
              f"{name} on the reference pickle vs sklearn: {err[name]} > {REF_LINEAR_ATOL}")
        check(np.array_equal(out[name][0][:, 0], e["linear_pred"]),
              f"{name} decisions differ from sklearn's")
    fused_fast = {}
    for name in REF_MODES[3:-1]:
        check(np.array_equal(out[name][0], out["fast_i8"][0]),
              f"{name} decisions != fast int8's on the reference pickle")
        fused_fast[name] = float(np.abs(out[name][2] - out["fast_i8"][2]).max())
        check(fused_fast[name] <= REF_FUSED_ATOL, f"{name} vs fast int8 {fused_fast[name]}")
    check(err["svc_exact"] <= SVC_PROBA_ATOL,
          f"the SVC pickle vs sklearn: {err['svc_exact']} > {SVC_PROBA_ATOL}")
    svc_ok = margin_ok(e["svc_proba"], e["svc_proba"].max(1), 0.0, SVC_MARGIN)
    check(np.array_equal(out["svc_exact"][0][svc_ok, 0], e["svc_proba"].argmax(1)[svc_ok]),
          "the SVC pickle's decisions differ from sklearn's where the margin exceeds 1e-3")

    # c. each kernel against its plain version on this model and these scans
    dims = DEFAULT_ARENA.grid_shape
    quant2 = preds["fused_combo"]._quantized_split_templates(2)
    w_combo = i8_score.build_combined_weights(quant2, dims, levels=2, device=dev)
    w_tails = i8_tails.build_grouped_weights(quant2, dims, 16, device=dev)
    cube = src["fused_combo"]
    ijk = torch.stack(preds["fused_combo"]._indices(xyz_d), -1).to(torch.int32)
    pairs = {"onepass_tables_combined_i8": (
        lambda: i8_score.onepass_tables_combined_i8(cube, w_combo),
        lambda: i8_score.onepass_tables_combined_i8_ref(cube, w_combo))}
    for name in TAIL_KERNELS:
        pairs[name] = tail_fns(name, w_tails, cube, ijk, None)
    kernel_err = {}
    for name, (kern, plain) in pairs.items():
        got, ref = kern(), plain()
        kernel_err[name] = max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))
        check(all(torch.equal(g, r) for g, r in zip(got, ref)),
              f"{name} != its plain version on the reference model")
    tm = score.native_templates(*preds["pallas"]._split_templates(), device=dev)
    native = native_errors(src["pallas"], tm)
    for k_err, p_err, o_max, _, again in native:
        check(k_err <= 2 * p_err + 1e-6 * o_max and again,
              f"B7 on the reference model: {k_err} vs plain {p_err}")
    kernel_err["fused_native_score"] = max(t[3] for t in native)
    rows = []
    for b, t in enumerate(targets):
        i, j, k = (int(v) for v in DEFAULT_ARENA.clamped_matrix_indices(t.x, t.y, t.z))
        rows.append((cubes[b][:, j, :], cubes[b][i, :, :], cubes[b][:, :, k]))
    F = process_samples(rows, scale=True, device=dev)
    ((_, k_err, p_err, _, _),) = rbf_errors(F, svc_model.support_vectors, (svc_model.gamma,))
    check(k_err <= 2 * p_err + 1e-6, f"B6 on the reference SVC: {k_err} vs plain {p_err}")
    kernel_err["rbf_gram"] = float((rbf.rbf_gram(F, svc_model.support_vectors, svc_model.gamma)
                                    - rbf.rbf_gram_ref(F, svc_model.support_vectors,
                                                       svc_model.gamma)).abs().max())

    # d. each mode's step at B=64, inputs on the card
    ms = interleaved({name: (lambda p=preds[name], c=src[name]: p(c, xyz_d, valid_d))
                      for name in REF_MODES}, inner=10, rounds=3)

    # e. the predict app in a process of its own, --mode fused, against a
    # direct call on the same synthetic scans
    n_app, batch_app, minp = 128, 64, 0.5
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", PREDICT_CHILD, "--svm_model", path["svm_radar_classifier"],
         "--label_encoder", path["radar_labels"], "--min_proba", str(minp),
         "--log_file", os.path.join(d, "predict.log"), "--driver", "synthetic",
         "--driver_seed", "1234", "--mode", "fused", "--batch_scans", str(batch_app),
         "--num_scans", str(n_app), "--logging_level", "warning"],
        cwd=d, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": HERE})
    app_s = time.perf_counter() - t0
    check(child.returncode == 0, f"the predict app failed: {child.stderr[-2000:]}")
    app = json.loads(child.stdout.strip().splitlines()[-1])
    check(not app["sklearn"], f"the predict app imported {app['sklearn']}")
    direct = RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, model, calib, min_proba=minp,
                            mode="fused", device=dev)
    scans, lists = synthetic_scans(n_app, 1234)
    axyz, avalid = pad_targets(lists, 4)
    pr, best, _ = (r.cpu().numpy() for r in direct(scans, axyz, avalid))
    want = [("Unknown" if pr[b, t] == -1 else classes[int(pr[b, t])], float(best[b, t]))
            for b in range(n_app) for t in range(4) if avalid[b, t]]
    got = app["results"]
    check([m for m, _ in got] == [m for m, _ in want], "the predict app's names != direct")
    d_app = float(np.abs(np.array([p for _, p in got]) - np.array([p for _, p in want])).max())
    check(d_app <= 1e-6, f"the predict app vs a direct call {d_app}")
    check(not sklearn_modules(), f"phase 16 imported {sklearn_modules()}")
    res = {"max_err_vs_sklearn": err, "fused_vs_fast_i8": fused_fast, "launches": launched,
           "kernel_vs_plain": kernel_err, "step_ms_b64": ms, "predict_app_s": app_s,
           "predict_app_targets": len(got), "predict_app_delta": d_app,
           "s": time.perf_counter() - t_phase}
    say("reference", f"on {smi}: the reference's pickles (radarml_tpu_torch/assets/"
        f"reference_pickles/, sklearn {e['sklearn_version']}, numpy {e['numpy_version']}) "
        f"loaded with no sklearn module; {n} scans x 4 slots (one target), max |proba - "
        "sklearn|: " + ", ".join(f"{k} {v:.2e}" for k, v in err.items())
        + f" (bars {REF_LINEAR_ATOL} linear, {SVC_PROBA_ATOL} SVC), linear decisions == "
        f"sklearn's, SVC's on {int(svc_ok.sum())} of {n} with margin > 1e-3; fused == fast "
        "int8 decisions, proba delta " + ", ".join(f"{k} {v:.2e}" for k, v in fused_fast.items())
        + "; launches " + ", ".join(f"{k} {v}" for k, v in launched.items())
        + "; each kernel == its plain version on this model (max |kernel - plain| "
        + ", ".join(f"{k} {v:.3g}" for k, v in kernel_err.items())
        + "); step ms at B=64 (CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f"; predict --mode fused in its own process ({app_s:.1f} s): {len(got)} targets == "
        f"a direct call (proba delta {d_app:.2e}); phase 16 in {res['s']:.1f} s")
    return res


# -- the shapes past the table kernels' earlier limits (phases 3, 6, 17) ----------

# The finer scan arenas: tests/test_apps.py:580 (the predict app's
# --scan_arena 10,360,1,-42,42,2,-30,30,2), tests/test_pipeline.py:388, and
# every axis at half the default step.
FINE_ARENAS = {"43x31x351": dict(r_res=1.0, theta_res=2.0), "22x31x351": dict(r_res=1.0),
               "43x61x351": dict(r_res=1.0, theta_res=2.0, phi_res=1.0)}
FINE_SPEC = "10,360,1,-42,42,2,-30,30,2"  # FINE_ARENAS["43x31x351"] as the apps take it
# (class rows C2, levels) of phase 3's cases past one class group of 8 rows
SHAPE_ROWS = ((10, 2), (16, 2), (18, 2), (32, 2), (9, 1), (16, 1))
# phase 3's batch of many waves at 43x31x351 (the plain versions' float64
# einsums of 4096 such scans would hold ~45 GB)
FINE_B = 1024
# The predict app twice in one process of its own, --mode fused with split
# and with single quantization (the app has no pallas mode, in the JAX
# package or the port): both results as one JSON line.
PREDICT_TWICE = """import json, sys
from radarml_tpu_torch.apps import predict
argv = sys.argv[1:] + ["--mode", "fused", "--fused_quant"]
print(json.dumps({q: predict.main(argv + [q]) for q in ("split", "single")}))
"""


def offset_view(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A contiguous copy of t that starts `nbytes` into its buffer (so
    off 16-byte alignment)."""
    k = nbytes // t.element_size()
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    v = buf[k:].view(t.shape)
    v.copy_(t)
    return v


def shape_parity(dev, rng) -> str:
    """Phase 3's cases past the earlier limits. B1-B5 equal their plain
    versions (torch.equal) at C2 6 (levels 2, the finer arenas only), 10 /
    16 / 18 / 32 (levels 2) and 9 / 16 (levels 1): B 1 / 7 / 64 / 133 at
    the default arena and B 4096 there at C2 9 / 10 / 18 / 32 (9 and 10:
    one block of two n-tiles a scan from a batch of five scans an SM on),
    at C2 10 also five scans an SM and one fewer, each plane masked and a
    cube one byte off alignment; B 7 /
    64 at the three finer arenas (Z = 351: the staged route) and B 1024 at
    43 x 31 x 351 with C2 = 6, each plane masked in turn at 43 x 31 x 351
    with C2 = 10, and a cube that starts one byte into its buffer there;
    each case's plan at its batch (rows a block, slab width) equal to the
    host mirror's (ops/i8_score.batch_plan).
    B7 within its bars at C 8 / 9 / 16 (class groups) and at the finer
    arenas (C 1 / 2 / 3 / 5 and 9: the long-row instance; 43 x 61 x 351
    at C 3 / 5 in two z-chunks), at B 1024 at 43 x 31 x 351 with C 3 and
    with a cube 2 bytes off 16-byte alignment there, its plan the host
    mirror's (ops/score.native_plan). Returns the progress line."""
    dims = DEFAULT_ARENA.grid_shape
    fine = {k: Arena(**v).grid_shape for k, v in FINE_ARENAS.items()}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [(dims, B, c2, lv, None) for c2, lv in SHAPE_ROWS for B in (1, 7, SMALL_B, 133)]
    # the main path's batch at the default arena (9 and 10 rows: one block of
    # two n-tiles a scan), and there at 10 rows each plane masked and a cube
    # off 16-byte alignment (the byte-copy route)
    cases += [(dims, BIG, c2, lv, None) for c2, lv in ((9, 1), (10, 2), (18, 2), (32, 2))]
    cases += [(dims, BIG, 10, 2, m) for m in (0, 1, 2)] + [(dims, BIG, 10, 2, "offset")]
    cases += [(dims, i8_score.ONE_BLOCK_SCANS_PER_SM * sms + d, 10, 2, None) for d in (-1, 0)]
    cases += [(fd, B, c2, lv, None) for fd in fine.values()
              for c2, lv in ((6, 2),) + SHAPE_ROWS for B in (7, SMALL_B)]
    cases += [(fine["43x31x351"], 7, 10, 2, m) for m in (0, 1, 2)]
    cases += [(fine["43x31x351"], FINE_B, 6, 2, None), (fine["43x31x351"], 7, 6, 2, "offset")]
    lib = i8_score._library()
    n_runs, err = 0, 0
    for cdims, B, c2, levels, masked in cases:
        offset = masked == "offset"
        masked = None if offset else masked
        w = i8_tails.build_grouped_weights(random_quant(rng, cdims, levels, masked, C=c2 // levels),
                                           cdims, min(16, cdims[1]), levels=levels, device=dev)
        planes = tuple(q is not None for q in (w.q_xz, w.q_yz, w.q_xy))
        plan = int8_plan(lib, cdims, c2, planes, B)
        check(1 <= plan[0] <= 8 * i8_score.MAX_TILES and plan[1] >= 1,
              f"no int8 plan at dims={cdims} C2={c2}")
        check(plan == i8_score.batch_plan(B, sms, *cdims, c2, planes),
              f"int8 plan {plan} != the host mirror's at dims={cdims} C2={c2} planes={planes} "
              f"B={B}")
        cube = torch.from_numpy(rng.integers(-128, 128, (B,) + cdims, dtype=np.int8)).to(dev)
        if offset:
            cube = offset_view(cube, 1)
        ijk = slots(rng, cdims, B, 4, dev)
        valid = torch.from_numpy(rng.random((B, 4)) < 0.75).to(dev)
        runs = [("onepass_tables_combined_i8",
                 (lambda: i8_score.onepass_tables_combined_i8(cube, w),
                  lambda: i8_score.onepass_tables_combined_i8_ref(cube, w)))]
        runs += [(name, tail_fns(name, w, cube, ijk,
                                 valid if name == "onepass_scores_i8" else None))
                 for name in TAIL_KERNELS]
        for name, (kernel, plain) in runs:
            got = kernel()
            torch.cuda.synchronize()
            for g, r in zip(got, plain()):
                err = max(err, int((g.long() - r.long()).abs().max()))
                check(g.shape == r.shape and torch.equal(g, r),
                      f"{name} != plain at dims={cdims} B={B} C2={c2} levels={levels} "
                      f"masked={masked}")
            if masked is not None:
                check(not got[masked].any(), f"{name}: masked plane gave non-zero")
            n_runs += 1
    native_cases = ([(dims, B, C) for C in (8, 9, 16) for B in (7, 300)]
                    + [(fd, B, C) for fd in fine.values() for C in (3, 5) for B in (7, SMALL_B)]
                    + [(fine["43x31x351"], 7, C) for C in (1, 2, 9)]
                    + [(fine["43x31x351"], FINE_B, 3), (fine["43x31x351"], 7, "offset")])
    nlib = score._library()
    cgen = torch.Generator(device=dev).manual_seed(17)
    worst = 0.0
    for ndims, B, C in native_cases:
        offset = C == "offset"
        C = 3 if offset else C
        plan = (nlib.native_score_plan_zchunk(*ndims, C), nlib.native_score_plan_group(*ndims, C))
        check(plan == score.native_plan(*ndims, C),
              f"B7 plan {plan} != the host mirror's at dims={ndims} C={C}")
        X, Y, Z = ndims
        tm = score.native_templates(*[rng.normal(size=(C,) + sh).astype(np.float32) * 0.01
                                      for sh in ((X, Z), (Y, Z), (X, Y))], device=dev)
        cube = (torch.rand((B,) + ndims, generator=cgen, device=dev) * 255).to(torch.bfloat16)
        if offset:
            cube = offset_view(cube, 2)
        for t, (ek, er, omax, _, same) in zip(("m1", "m2", "m3"), native_errors(cube, tm)):
            where = f"B7 {t} at dims={ndims} B={B} C={C}{' off 16 bytes' if offset else ''}"
            check(same, f"{where}: a second call gave other bits")
            check(ek <= 2.0 * er + 1e-6 * omax,
                  f"{where}: error vs float64 {ek:.3e} > 2x plain {er:.3e} + 1e-6 x {omax:.3e}")
            worst = max(worst, ek / max(2.0 * er + 1e-6 * omax, 1e-30))
    plans = {f"{k} C2={c2}": int8_plan(lib, fd, c2, (1, 1, 1), BIG)
             for k, fd in fine.items() for c2 in (6, 10, 18)}
    plans |= {f"22x31x176 C2={c2} B={B}": int8_plan(lib, dims, c2, (1, 1, 1), B)
              for c2 in (9, 10, 18, 32) for B in (SMALL_B, BIG)}
    nplans = {f"{k} C={C}": score.native_plan(*fd, C) for k, fd in fine.items() for C in (3, 9)}
    return (f"past the earlier limits: B1-B5 equal their plain versions in {n_runs} runs "
            f"({len(cases)} cases: C2 6 at the finer arenas, 10/16/18/32 at levels 2 and "
            f"9/16 at levels 1, B 1/7/64/133 at {dims} and B 7/64 at {', '.join(fine)}, B "
            f"{BIG} at {dims} with C2 9/10/18/32, and at C2=10 each plane masked and a cube 1 "
            f"byte off alignment (one block of two n-tiles), B {FINE_B} at 43x31x351 C2=6, each "
            f"plane masked at 43x31x351 C2=10, a cube 1 byte off alignment there; max_abs_err "
            f"{err}); plans (rows a block, slab width) at the batch "
            f"{plans}, each the host mirror's; B7 within its bars in {len(native_cases)} cases "
            f"(C 8/9/16 at {dims}, C 3/5 at the finer arenas, C 1/2/9 and B {FINE_B} at 43x31x351, "
            f"a cube 2 bytes off alignment there; worst error at {worst:.2f} of its bar), "
            f"each B7 plan (z-chunk, class group) the host mirror's: {nplans}")


def int8_plan(lib, dims, c2: int, planes, B: int) -> tuple:
    """The int8 kernels' whole-scan plan at a batch of B scans as a built
    library reports it (i8_score_batch_rows, i8_score_batch_width): rows a
    block, slab width, the form of its host mirror ops/i8_score.batch_plan."""
    return (lib.i8_score_batch_rows(B, *dims, c2, *planes),
            lib.i8_score_batch_width(B, *dims, c2, *planes))


def native_launches(dims, C: int) -> int:
    """B7's launches a call at these dims and classes: one a z-chunk and
    class group of its plan (ops/score.native_plan)."""
    zc, cg = score.native_plan(*dims, C)
    return -(-dims[2] // zc) * -(-C // cg)


C7_BATCHES = (1, 7, 64, 128, BIG)


def c7_table(dev, smi, phase: str, fine: bool) -> dict:
    """ROADMAP C7: the demo model's exact, fast and fast int8 steps at B 1 /
    7 / 64 / 128 / 4096 beside the einsums the fast modes replaced
    (`utils/route_bench.route_table`, CUDA events, 4 slots), at the default
    or the 43 x 31 x 351 scan arena. Fails if fast int8's tables differ
    by a bit from the int64 route's (the float64 einsums' integers on the
    card, the CPU's int64 einsums up to 128 scans)."""
    arena = "43x31x351" if fine else "22x31x176"
    t0 = time.perf_counter()
    table = route_bench.route_table(dev, fine, batches=C7_BATCHES, forced_routes=False)
    for B, r in table.items():
        check(all(r["bits"].values()),
              f"fast int8's tables differ from the int64 route's at {arena}, B={B}: {r['bits']}")
    say(phase, f"C7 on {smi} at {arena}, the demo model's step in ms by CUDA events, 4 slots "
        "(fast: M1 in one product while one x's slab of the batch is at most "
        f"pipeline.M1_SLAB_BYTES = {M1_SLAB_BYTES >> 20} MiB, else one a x; fast int8: m1 and m3 "
        "over the (scan, x) blocks while the bytes they move are at most "
        f"pipeline.EXACT_BLOCK_BYTES = {EXACT_BLOCK_BYTES >> 20} MiB, else a x; einsums: the forms "
        "they replaced): " + "; ".join(
            f"B={B}: exact {r['ms']['exact']:.4f}, fast {r['ms']['fast']:.4f} (einsums "
            f"{r['ms']['fast_einsum']:.4f}), fast int8 {r['ms']['fast_i8']:.4f} (einsums "
            f"{r['ms']['fast_i8_einsum']:.4f})" for B, r in table.items())
        + "; fast int8's tables == the int64 route's at every batch; "
        f"{time.perf_counter() - t0:.1f} s")
    return table


def shape_timing(dev) -> dict:
    """Phase 6 at the new shapes: each table kernel's device time at
    B=4096 and B=64 with its bound, at 9 classes on the default arena (the
    int8 kernels at C2 = 18, three class groups of 6 rows; B7 at C = 9, 3
    groups of 3 on the long-row instance), at 5 classes there (C2 = 10: one
    block of two n-tiles a scan at B=4096, slabs 8 x rows wide; two class
    groups at B=64), at 43 x 31 x 351 with 3 classes (C2 = 6, the staged
    route, slabs 5 x rows wide; B7 one launch of the long-row instance) and
    with 9 (C2 = 18: class groups). "device" is the device time of one op call,
    summed over the CUDA launches its plan makes ("launches"), so that it
    stands beside the call's bound. Random int8 / bf16 cubes and
    templates, 4 slots a scan. At 9 classes and at 43 x 31 x 351 with 3,
    by CUDA events, the fast path's float32 tables (pipeline.folded_tables,
    B7's comparator "fast_f32") on the float32 cube with B7's templates.
    Returns {shape:
    {name: {B: {"device": ms, "launches": n, "bound": ms, "bound_by": ...}}}}
    with "fast_f32" {B: ms} at those two shapes."""
    gen = torch.Generator(device=dev).manual_seed(6)
    rng = np.random.default_rng(6)
    out = {}
    fine = Arena(**FINE_ARENAS["43x31x351"]).grid_shape
    for shape, dims, C in (("9_classes", DEFAULT_ARENA.grid_shape, 9),
                           ("5_classes", DEFAULT_ARENA.grid_shape, 5), ("43x31x351", fine, 3),
                           ("43x31x351_9", fine, 9)):
        X, Y, Z = dims
        cube = torch.randint(-128, 128, (BIG,) + dims, generator=gen, device=dev,
                             dtype=torch.int8)
        bf = (torch.rand((BIG,) + dims, generator=gen, device=dev) * 255).to(torch.bfloat16)
        ijk = torch.stack([torch.randint(0, n, (BIG, 4), generator=gen, device=dev)
                           for n in dims], -1).to(torch.int32)
        w = i8_tails.build_grouped_weights(random_quant(rng, dims, 2, C=C), dims, 16, device=dev)
        tm = score.native_templates(*[torch.randn((C,) + sh, generator=gen, device=dev) * 0.01
                                      for sh in ((X, Z), (Y, Z), (X, Y))])
        res = {}
        for B in (BIG, SMALL_B):
            c, k = cube[:B], ijk[:B]
            fns = {"onepass_tables_combined_i8":
                   lambda c=c: i8_score.onepass_tables_combined_i8(c, w)}
            for name in TAIL_KERNELS:
                fns[name] = tail_fns(name, w, c, k, None)[0]
            fns["native_tables"] = lambda b=bf[:B]: score.native_tables(b, tm)
            per_call = {n: native_launches(dims, C) if n == "native_tables" else 1 for n in fns}
            got = kernel_device_calls(fns, {n: KERNEL_SYMBOLS[n] for n in fns}, reps=5,
                                      log=retrace, launches=per_call)
            for name, (v, n) in got.items():
                b_ms, b_by = (native_bound(B, dims, C) if name == "native_tables"
                              else int8_bound(name, B, dims, 2 * C, 4))
                res.setdefault(name, {})[B] = {"device": v, "launches": n, "bound": b_ms,
                                               "bound_by": b_by}
        if shape in ("9_classes", "43x31x351"):  # B7's comparator
            del cube
            f32 = bf.float()
            fast_t = (tm.t_xz, tm.t_yz, tm.t_xy)
            res["fast_f32"] = {B: interleaved({"f": lambda c=f32[:B]: folded_tables(c, fast_t)},
                                              inner=3 if B == BIG else 20, rounds=3)["f"]
                               for B in (BIG, SMALL_B)}
            del f32, bf
        out[shape] = res
    return out


def build_parent(parent: str, tmp: str) -> dict:
    """The parent tree's i8_score.cu and native_score.cu (PARENT/radarml_tpu_torch/
    ops/csrc), built with the port's nvcc flags into `tmp` by
    utils/kernel_probe.build_variants and bound by the wrappers' own
    `_bind`: name -> ctypes library."""
    csrc = os.path.join(parent, "radarml_tpu_torch", "ops", "csrc")
    libs = {}
    for name, bind in (("i8_score", i8_score._bind), ("native_score", score._bind)):
        with open(os.path.join(csrc, f"{name}.cu")) as f:
            text = f.read()
        libs[name] = bind(kernel_probe.build_variants(name, {}, Path(tmp),
                                                      {"parent": text})["parent"])
    return libs


def c_calls(lib, nlib, dev, cube, w, ijk, bf16, tm) -> dict:
    """The five int8 kernels and B7 through a built library's C entries
    (this tree's or a parent's) on these operands: name -> call."""
    B = cube.shape[0]
    X, Y, Z, _ = w.dims
    C2, T = w.c2, ijk.shape[1]
    kidx = ijk[..., 2].contiguous()
    qp = [q.data_ptr() for q in (w.q_xz, w.q_yz, w.q_xy)]
    # the lookup kernels' plan from this library's own resident blocks and
    # slab width at this batch (a parent's, whose plan has no batch, may differ)
    resident = kernel_probe.lib_resident(lib, "lookup", (X, Y, Z), C2, B)
    rows, width = kernel_probe.lib_plan(lib, (X, Y, Z), C2, B)
    check(resident > 0, f"the lookup kernel's resident blocks: CUDA error {-resident}")
    P, XS = i8_tails.lookup_plan(B, X, max(1, resident // -(-C2 // rows)), width)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def outs(*shapes):
        return [torch.empty(sh, dtype=torch.int32, device=dev) for sh in shapes]

    def run(fn, extra, o, *ints):
        err = getattr(lib, fn)(cube.data_ptr(), *qp, *extra, *[t.data_ptr() for t in o],
                               B, X, Y, Z, C2, *ints, stream)
        check(err == 0, f"{fn} failed: CUDA error {err}")
        return o

    tabs = ((B, C2, Y), (B, C2, X), (B, Z, C2))

    def native():
        m = [torch.empty((B, tm.dims[3], n), dtype=torch.float32, device=dev) for n in (Y, X, Z)]
        err = nlib.native_score_tables(bf16.data_ptr(), tm.t_xz.data_ptr(), tm.t_yz.data_ptr(),
                                       tm.t_xy.data_ptr(), *[t.data_ptr() for t in m], B, X, Y,
                                       Z, tm.dims[3], stream)
        check(err == 0, f"native_score_tables failed: CUDA error {err}")
        return m

    return {
        "onepass_tables_combined_i8": lambda: run("i8_score_onepass_tables", (), outs(*tabs)),
        "onepass_tables_i8": lambda: run("i8_score_lookup_tables", (), outs(*tabs), XS, P),
        "onepass_tables_grouped_i8": lambda: run("i8_score_grouped_tables", (), outs(*tabs),
                                                 XS, P),
        "onepass_tables_sel_i8": lambda: run("i8_score_sel_tables", (kidx.data_ptr(),),
                                             outs(tabs[0], tabs[1], (B, T, C2)), T),
        "onepass_scores_i8": lambda: run("i8_score_sel3_scores", (ijk.data_ptr(), None),
                                         outs(*[(B, T, C2)] * 3), T),
        "native_tables": native,
    }


def parent_compare(dev, smi, parent: str, cube, w, ijk, bf16, tm) -> dict:
    """The parent's kernel sources beside this tree's in one process. The
    kernels at B=4096 on phase 6's inputs (the demo model's templates, the
    tiled demo scans), through their C entries, the same bits from both,
    device times from profiler traces in the order parent, this tree,
    this tree, parent, twice over; then at the shapes past one class group
    (compare_shape: 9 and 5 classes at the default arena, 3 and 9 at
    43 x 31 x 351), B=4096 and 64. Returns {"default": {tag: {name:
    [ms]}}, shape: {B: {tag: {name: [ms]}}}}."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="parent_kernels_") as tmp:
        parent_libs = build_parent(parent, tmp)
    build_s = time.perf_counter() - t0
    libs = {"parent": parent_libs, "this tree": {"i8_score": i8_score._library(),
                                                 "native_score": score._library()}}
    X, Y, Z, _ = w.dims
    dims_default = (X, Y, Z)
    C2 = w.c2
    check(kernel_probe.lib_plan(parent_libs["i8_score"], dims_default, C2, BIG)
          == kernel_probe.lib_plan(libs["this tree"]["i8_score"], dims_default, C2, BIG),
          "the parent's whole-scan plan differs at the default arena")
    symbols = {n: KERNEL_SYMBOLS[n] for n in KERNEL_SYMBOLS}

    def timed(fns, launches, rounds, reps):
        times = {tag: {name: [] for name in fns[tag]} for tag in fns}
        for tag in ("parent", "this tree", "this tree", "parent") * rounds:
            ms = kernel_device_ms(fns[tag], {n: symbols[n] for n in fns[tag]}, reps=reps,
                                  log=retrace, launches=launches[tag])
            for name, v in ms.items():
                times[tag][name].append(v)
        return times

    def line(times):
        return "; ".join(
            f"{name} parent {'/'.join(f'{v:.4f}' for v in times['parent'][name])}, this tree "
            f"{'/'.join(f'{v:.4f}' for v in times['this tree'][name])}"
            for name in times["parent"])

    fns = {tag: c_calls(v["i8_score"], v["native_score"], dev, cube, w, ijk, bf16, tm)
           for tag, v in libs.items()}
    for name in fns["parent"]:
        a, b = fns["parent"][name](), fns["this tree"][name]()
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{name}: the parent's sources and this tree's give other bits at the default")
    one = {tag: dict.fromkeys(fns[tag], 1) for tag in fns}
    out = {"default": timed(fns, one, 2, 20)}
    say("timing", f"B={cube.shape[0]} on {smi}, the parent's kernel sources ({parent}, built "
        f"in {build_s:.1f} s) beside this tree's, same bits, device ms in the order P N N P "
        "twice: " + line(out["default"]))

    # The shapes past one class group: 9 and 5 classes at the default arena
    # (C2 18: class groups; 10: one block of two n-tiles), 3 and 9 at
    # 43 x 31 x 351 (the staged route and B7's long-row instance); random
    # cubes and templates as shape_timing makes them
    fdims = Arena(**FINE_ARENAS["43x31x351"]).grid_shape
    for label, sdims, C in (("43x31x351", fdims, 3), ("9_classes", dims_default, 9),
                            ("5_classes", dims_default, 5), ("43x31x351_9", fdims, 9)):
        out[label] = compare_shape(dev, smi, libs, timed, line, label, sdims, C)
    return out


def compare_shape(dev, smi, libs, timed, line, label, dims, C) -> dict:
    """parent_compare at one shape: the five int8 kernels and B7 of the
    parent's sources and this tree's on the same random cubes and
    templates (C classes, levels 2), B=4096 and 64: the int8 kernels the
    same bits, B7 each within its float64 bar; device ms a call, P N N P
    (twice at B=4096). Returns {B: {tag: {name: [ms]}}}."""
    X, Y, Z = dims
    gen = torch.Generator(device=dev).manual_seed(18)
    w = i8_tails.build_grouped_weights(random_quant(np.random.default_rng(18), dims, 2, C=C),
                                       dims, 16, device=dev)
    tm = score.native_templates(*[torch.randn((C,) + sh, generator=gen, device=dev) * 0.01
                                  for sh in ((X, Z), (Y, Z), (X, Y))])
    cube = torch.randint(-128, 128, (BIG,) + dims, generator=gen, device=dev, dtype=torch.int8)
    bf = (torch.rand((BIG,) + dims, generator=gen, device=dev) * 255).to(torch.bfloat16)
    ijk = torch.stack([torch.randint(0, n, (BIG, 4), generator=gen, device=dev)
                       for n in dims], -1).to(torch.int32)
    pn = libs["parent"]["native_score"]
    nl = {"parent": -(-Z // pn.native_score_plan_zchunk(*dims, C))
          * -(-C // pn.native_score_plan_group(*dims, C)),
          "this tree": native_launches(dims, C)}
    out = {}
    for B in (BIG, SMALL_B):
        fns = {tag: c_calls(v["i8_score"], v["native_score"], dev, cube[:B], w, ijk[:B], bf[:B],
                            tm) for tag, v in libs.items()}
        for name in fns["parent"]:
            a, b = fns["parent"][name](), fns["this tree"][name]()
            torch.cuda.synchronize()
            if name != "native_tables":
                check(all(torch.equal(x, y) for x, y in zip(a, b)),
                      f"{name}: the parent's and this tree's bits differ at {dims} C={C} B={B}")
                continue
            v = bf[:B].double()
            for t, x, y, spec in zip((tm.t_xz, tm.t_yz, tm.t_xy), a, b,
                                     ("cxz,bxyz->bcy", "cyz,bxyz->bcx", "cxy,bxyz->bcz")):
                o = torch.einsum(spec, t.double(), v)
                ea, eb = (float((r.double() - o).abs().max()) for r in (x, y))
                check(eb <= 2.0 * ea + 1e-6 * float(o.abs().max()),
                      f"B7 at {dims} C={C} B={B}: this tree's error {eb:.3e} vs the parent's "
                      f"{ea:.3e}")
            del v
        launches = {tag: dict.fromkeys(fns[tag], 1) | {"native_tables": nl[tag]} for tag in fns}
        out[B] = timed(fns, launches, 2 if B == BIG else 1, 10 if B == BIG else 20)
        say("timing", f"{label}: {dims} {C} classes B={B} on {smi}, the parent's kernel sources "
            f"beside this tree's (B7 {nl['parent']} / {nl['this tree']} launches a call; the "
            "int8 kernels' bits equal, B7 each within its float64 bar), device ms a call, "
            "P N N P: " + line(out[B]))
    return out


def phase_shapes(dev, smi) -> dict:
    """Phase 17: the shapes past the table kernels' earlier limits served
    on the card, with the predict app's files in a temporary directory."""
    with tempfile.TemporaryDirectory() as d:
        return shapes_in(d, dev, smi)


def shapes_in(d, dev, smi) -> dict:
    t_phase = time.perf_counter()
    g = dict(np.load(ASSET))
    rng = np.random.default_rng(17)
    fine = Arena(**FINE_ARENAS["43x31x351"])
    F = DEFAULT_ARENA.feature_length
    models = {"demo_43x31x351": (fine, g["coef"], g["intercept"], g["calib_a"], g["calib_b"],
                                 float(g["min_proba"]))}
    for C in (5, 9):
        models[f"{C}_classes"] = (DEFAULT_ARENA, rng.normal(size=(C, F)).astype(np.float32) * 0.01,
                                  rng.normal(size=C).astype(np.float32),
                                  -rng.uniform(0.5, 2.0, size=C).astype(np.float32),
                                  (rng.normal(size=C) * 0.1).astype(np.float32), 0.3)
    # The predict app in a process of its own on the demo model at the
    # finer scan arena, --mode fused (split and single), running while the
    # models below are served; its results are held to direct calls after.
    lin, le = os.path.join(d, "linear.pkl"), os.path.join(d, "le.pkl")
    classes = [str(c) for c in g["classes"]]
    common_cli.save_label_encoder(le, LabelEncoder(tuple(classes)))
    common_cli.save_model(lin, "linear", coef=g["coef"], intercept=g["intercept"],
                          calib_a=g["calib_a"], calib_b=g["calib_b"], classes=classes)
    n_app, minp_app = 16, 0.5
    t_app = time.perf_counter()
    app_out, app_err = os.path.join(d, "app.out"), os.path.join(d, "app.err")
    with open(app_out, "w") as fo, open(app_err, "w") as fe:  # files: a pipe could fill
        child = subprocess.Popen(
            [sys.executable, "-c", PREDICT_TWICE, "--svm_model", lin, "--label_encoder", le,
             "--min_proba", str(minp_app), "--log_file", os.path.join(d, "predict.log"),
             "--driver", "synthetic", "--driver_seed", "1234", "--scan_arena", FINE_SPEC,
             "--batch_scans", str(n_app), "--num_scans", str(n_app), "--logging_level",
             "warning"], cwd=d, stdout=fo, stderr=fe, env={**os.environ, "PYTHONPATH": HERE})
    before = launch_counts()
    calls = dict.fromkeys(before, 0)
    rows, model_s = {}, {}
    for mname, (arena, coef, icpt, ca, cb, minp) in models.items():
        t_model = time.perf_counter()
        model, calib = from_numpy(coef, icpt, ca, cb, device=dev)
        kw = dict(train_arena=DEFAULT_ARENA, scan_arena=arena, model=model, calibration=calib,
                  min_proba=minp, device=dev)
        preds = {"exact": RadarPredictor(mode="exact", **kw),
                 "fast": RadarPredictor(mode="fast", **kw),
                 "fast_i8": RadarPredictor(mode="fast", cube_dtype="int8", **kw),
                 "fused_single": RadarPredictor(mode="fused", fused_quant="single", **kw),
                 "pallas": RadarPredictor(mode="pallas", cube_dtype="bfloat16", **kw),
                 "pallas_f32": RadarPredictor(mode="pallas", **kw)}
        for tail, _ in [("combo", None)] + list(TAIL_KERNELS.values()):
            preds[f"fused_{tail}"] = RadarPredictor(mode="fused", fused_tail=tail, **kw)
        cubes, targets = make_scan_batch(SMALL_B, arena=arena, seed=int(g["scan_seed"]))
        cubes = np.rint(cubes)
        xyz, valid = pad_targets([[(t.x, t.y, t.z)] for t in targets], max_targets=4)
        reps = BIG // SMALL_B
        src64 = {"f32": torch.from_numpy(cubes.astype(np.float32)).to(dev),
                 "i8": preds["fused_combo"].pack_host(cubes.astype(np.uint8)).to(dev)}
        src64["bf16"] = src64["f32"].to(torch.bfloat16)
        xyz64, valid64 = torch.from_numpy(xyz).to(dev), torch.from_numpy(valid).to(dev)
        for B in (SMALL_B, BIG):
            src = src64 if B == SMALL_B else {k: v.repeat(reps, 1, 1, 1) for k, v in src64.items()}
            bxyz = xyz64 if B == SMALL_B else xyz64.repeat(reps, 1, 1)
            bvalid = valid64 if B == SMALL_B else valid64.repeat(reps, 1)
            out = {}
            for name, p in preds.items():
                x = src["i8" if p.mode == "fused" else "bf16" if name == "pallas" else "f32"]
                res = p(x, bxyz, bvalid)
                out[name] = [r.cpu().numpy() for r in res]
                if p.mode == "fused":
                    calls[FUSED_KERNEL[p.fused_tail]] += 1
                elif p.mode == "pallas":
                    calls["fused_native_score"] += 1
            C = coef.shape[0]
            for name, (pr, best, proba) in out.items():
                check(pr.shape == (B, 4) and proba.shape == (B, 4, C)
                      and np.isfinite(proba).all() and np.isfinite(best).all(),
                      f"{mname} {name} B={B}: shapes / finite")
                check((pr[~np.asarray(bvalid.cpu())] == -1).all(),
                      f"{mname} {name} B={B}: padded slots not UNKNOWN")
            d_fused = {}
            for tail in ["combo"] + [t for t, _ in TAIL_KERNELS.values()]:
                f = out[f"fused_{tail}"]
                check(np.array_equal(f[0], out["fast_i8"][0]),
                      f"{mname} B={B}: fused {tail} decisions != fast int8's")
                d_fused[tail] = float(np.abs(f[2] - out["fast_i8"][2]).max())
                check(d_fused[tail] <= 1e-6, f"{mname} B={B}: fused {tail} proba {d_fused[tail]}")
            ok = margin_ok(out["fast"][2], out["fast"][1], minp)
            for name in ("pallas", "pallas_f32"):
                check(np.array_equal(out[name][0][ok], out["fast"][0][ok]),
                      f"{mname} B={B}: {name} decisions != fast f32's where the margin > 1e-4")
            rows[f"{mname} B={B}"] = {
                "fused_vs_fast_i8": max(d_fused.values()),
                "pallas_vs_fast": float(np.abs(out["pallas_f32"][2] - out["fast"][2]).max()),
                "decided": int(ok.sum())}
            if B == BIG and arena is fine:  # timed below, once the launches are counted
                timed = (preds, src, bxyz, bvalid)
        model_s[mname] = time.perf_counter() - t_model
    launched = rise(before)
    check(launched == calls, f"phase 17 launches {launched}, the calls imply {calls}")

    # The demo model at 43x31x351, B=4096: each mode's step by CUDA events
    # and each table kernel's device time a call from profiler traces, the
    # traces' launch records held to the launches.
    preds, src, bxyz, bvalid = timed

    def step(k):
        p = preds[k]
        x = src["i8" if p.cube_dtype == "int8" else "bf16" if k == "pallas" else "f32"]
        return lambda: p(x, bxyz, bvalid)

    modes = ("exact", "fast", "fast_i8", "pallas", "pallas_f32", "fused_combo", "fused_sel3")
    step_ms = interleaved({k: step(k) for k in modes}, inner=2, rounds=3)
    kernels = {f"fused_{t}": FUSED_KERNEL[t] for t in
               ["combo"] + [t for t, _ in TAIL_KERNELS.values()]} | {"pallas": "native_tables"}
    records_before = (TRACES["records"], TRACES["launches"])
    kdev = kernel_device_ms({k: step(k) for k in kernels},
                            {k: KERNEL_SYMBOLS[n] for k, n in kernels.items()}, reps=5,
                            log=retrace, launches=dict.fromkeys(kernels, 1))
    records = (TRACES["records"] - records_before[0], TRACES["launches"] - records_before[1])
    del timed, preds, src

    # The predict app's process ends here; its results against direct calls.
    child.wait(timeout=600)
    app_s = time.perf_counter() - t_app
    with open(app_out) as fo, open(app_err) as fe:
        out_app, err_app = fo.read(), fe.read()
    check(child.returncode == 0, f"the predict app failed: {err_app[-2000:]}")
    app = json.loads(out_app.strip().splitlines()[-1])
    model, calib = from_numpy(g["coef"], g["intercept"], g["calib_a"], g["calib_b"], device=dev)
    scans, lists = synthetic_scans(n_app, 1234, arena=fine)
    axyz, avalid = pad_targets(lists, 4)
    d_app = {}
    for quant in ("split", "single"):
        direct = RadarPredictor(DEFAULT_ARENA, fine, model, calib, min_proba=minp_app,
                                mode="fused", fused_quant=quant, device=dev)
        pr, best, _ = (r.cpu().numpy() for r in direct(scans, axyz, avalid))
        want_app = [("Unknown" if pr[b, t] == -1 else classes[int(pr[b, t])], float(best[b, t]))
                    for b in range(n_app) for t in range(4) if avalid[b, t]]
        got_app = app[quant]
        check(len(got_app) > 0 and [m for m, _ in got_app] == [m for m, _ in want_app],
              f"the predict app --fused_quant {quant} --scan_arena {FINE_SPEC}: names != direct")
        d_app[quant] = float(np.abs(np.array([p for _, p in got_app])
                                    - np.array([p for _, p in want_app])).max())
        check(d_app[quant] <= 1e-6, f"the predict app --fused_quant {quant} vs direct "
              f"{d_app[quant]}")
    c7 = c7_table(dev, smi, "shapes", fine=True)
    res = {"rows": rows, "launches": launched, "model_s": model_s, "predict_app_s": app_s,
           "step_ms_43x31x351": step_ms, "device_ms_43x31x351": kdev, "c7_43x31x351": c7,
           "trace_records": records,
           "predict_app_targets": {m: len(app[m]) for m in app}, "predict_app_delta": d_app,
           "s": time.perf_counter() - t_phase}
    say("shapes", f"on {smi}: a 5-class and a 9-class linear model at the default arena and "
        f"the demo model at the 43x31x351 scan arena ({FINE_SPEC}), B 64 and 4096 (64 "
        "synthetic scans tiled), 4 slots, through exact / fast / fast int8 / fused (combo, "
        "lookup, glookup, sel, sel3; single) / pallas (bf16, f32): every fused split tail == "
        "fast int8 decisions, pallas == fast f32 decisions where the margin > 1e-4; "
        + "; ".join(f"{k}: fused-fast_i8 proba {v['fused_vs_fast_i8']:.2e}, pallas-fast "
                    f"{v['pallas_vs_fast']:.2e}, {v['decided']} decided" for k, v in rows.items())
        + "; the demo model at 43x31x351, B=4096, ms a step by CUDA events: "
        + ", ".join(f"{k} {v:.4f}" for k, v in step_ms.items())
        + "; device ms a call from profiler traces: "
        + ", ".join(f"{k} {v:.4f}" for k, v in kdev.items())
        + f" (launch records {records[0]} of the {records[1]} launches)"
        + "; launches " + ", ".join(f"{k} {v}" for k, v in launched.items())
        + " (each its calls); s a model: " + ", ".join(f"{k} {v:.1f}" for k, v in model_s.items())
        + f"; predict --mode fused --fused_quant split / single --scan_arena "
        f"{FINE_SPEC} in its own process ({app_s:.1f} s): {res['predict_app_targets']} targets "
        f"== direct calls (proba delta {d_app}); phase 17 in {res['s']:.1f} s")
    return res


def main(argv) -> None:
    """`argv`: none, or --parent DIR: a tree of the parent commit (e.g.
    unpacked by git archive) whose kernel sources phase 6 builds and times
    beside this tree's."""
    parent = argv[argv.index("--parent") + 1] if "--parent" in argv else None
    marks = [time.perf_counter()]

    def lap(done: str) -> None:
        """Print the seconds of the phase just done, and since the start."""
        now = time.perf_counter()
        say("time", f"{done} in {now - marks[-1]:.1f} s ({now - marks[0]:.1f} s in all)")
        marks.append(now)

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

    lap("phase 1 (device)")
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

    lap("phase 2 (build)")
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
    say("kernel", f"B7 tables within 2x the plain float32 version's float64 error "
        f"(+1e-6 x max|oracle|) in {len(native_cases)} cases (B 1/7/64/300/4096 at "
        f"{dims} with C 3/2, B 7 with C 1/5/7 and a view 2 bytes off alignment, "
        f"(9, 13, 180) B 33, (5, 7, 9) B 5; integer and non-integer cubes), the same "
        f"bits on a second call; max |kernel - plain| {native_err:.3e}, "
        f"max |kernel - float64| {native_f64:.3e}, largest ratio to plain's error "
        f"{worst[0]:.2f} ({worst[1]})")
    t0 = time.perf_counter()
    say("kernel", shape_parity(dev, rng) + f"; in {time.perf_counter() - t0:.1f} s")

    lap("phase 3 (kernel)")
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

    lap("phase 4 (slice)")
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

    lap("phase 5 (serving)")
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
                                  log=retrace, launches=dict.fromkeys(fns, 1))
        int8_ms[B] = {name: {kind: ms[name, kind] for kind in ("kernel", "plain")}
                      | {"device": dev_ms[name]}
                      | dict(zip(("bound", "bound_by"), int8_bound(name, B, dims, 6, 4)))
                      for name in fns}
    # B7 on the demo model's float32 templates and the tiled demo scans in
    # bf16, beside the fast f32 path's three einsums on the float32 cube.
    f32_all = torch.from_numpy(tiled.astype(np.float32)).to(dev)
    bf16_all = f32_all.to(torch.bfloat16)
    tm_demo = score.native_templates(*preds["pallas"]._split_templates(), device=dev)
    fast_t = (tm_demo.t_xz, tm_demo.t_yz, tm_demo.t_xy)
    native_ms = {}
    for B, inner in ((BIG, 5), (SMALL_B, 50)):
        cb, cf = bf16_all[:B], f32_all[:B]
        ms = interleaved({
            "kernel": lambda c=cb: score.native_tables(c, tm_demo),
            "plain": lambda c=cb: score.native_tables_ref(c, tm_demo),
            "fast_f32": lambda c=cf: folded_tables(c, fast_t),
        }, inner=inner, rounds=5)
        ms["device"] = kernel_device_ms(
            {"native_tables": lambda c=cb: score.native_tables(c, tm_demo)},
            {"native_tables": KERNEL_SYMBOLS["native_tables"]}, reps=20,
            log=retrace, launches={"native_tables": 1})["native_tables"]
        ms["bound"], ms["bound_by"] = native_bound(B, dims, tm_demo.dims[3])
        native_ms[B] = ms
    # The lookup and glookup kernels on both sides of the batch below which
    # they cut scans, with the plan each launched.
    for kernel, name, fn in (
            ("lookup", "onepass_tables_i8", i8_tails.onepass_tables_i8),
            ("grouped", "onepass_tables_grouped_i8", i8_tails.onepass_tables_grouped_i8)):
        by_batch = {
            B: kernel_device_ms({"k": lambda c=packed[:B], fn=fn: fn(c, w_tails)},
                                {"k": KERNEL_SYMBOLS[name]}, reps=20, log=retrace,
                                launches={"k": 1})["k"]
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
            f"{t['device']}) vs plain {t['plain']:.4f} ms and the fast path's float32 tables "
            f"{t['fast_f32']:.4f} ms, bound {t['bound']:.4f} ms ({t['bound_by']}); "
            f"the earlier B7 design: device {EARLIER_B7_DEVICE_MS[B]} ms (PERF.md "
            f"section 6, not measured here)")
    say("timing", f"B={BIG} on {smi}: combo kernel single {kernel_single['kernel']:.4f} "
        f"ms vs plain {kernel_single['plain']:.4f} ms; "
        + "; ".join(f"{k} {rates[k]:.0f} scans/s ({step_ms[k]:.4f} ms/batch)"
                    for k in inputs))
    t0 = time.perf_counter()
    shape_ms = shape_timing(dev)
    say("timing", f"on {smi}, device ms a call (its CUDA launches summed) with the bound "
        "beside it, B=4096 / B=64 (random cubes and templates, 4 slots): " + "; ".join(
            f"{shape}: " + ", ".join(
                f"{name} {t[BIG]['device']:.4f} / {t[SMALL_B]['device']:.4f} in "
                f"{t[BIG]['launches']} / {t[SMALL_B]['launches']} launches a call (bound "
                f"{t[BIG]['bound']:.4f} / {t[SMALL_B]['bound']:.4f}, {t[BIG]['bound_by']})"
                for name, t in res.items() if name != "fast_f32")
            for shape, res in shape_ms.items()) + f"; in {time.perf_counter() - t0:.1f} s")
    nine_ms = shape_ms["9_classes"]["fast_f32"]
    say("timing", f"9 classes on {smi}, by CUDA events, B=4096 / B=64: B7's comparator, the "
        "fast path's float32 tables (folded_tables) on the float32 cube with B7's templates, "
        f"{nine_ms[BIG]:.4f} / {nine_ms[SMALL_B]:.4f} ms")
    fine_ms = shape_ms["43x31x351"]
    say("timing", f"43x31x351 on {smi}, by CUDA events, B=4096 / B=64: B7's comparator, the "
        "fast path's float32 tables (folded_tables) on the float32 cube with B7's templates, "
        f"{fine_ms['fast_f32'][BIG]:.4f} / {fine_ms['fast_f32'][SMALL_B]:.4f} ms (the demo "
        "model's steps there: phase 17's C7 table)")
    if parent is None:
        say("timing", "no --parent tree given: the parent's kernel sources are not timed")
    else:
        parent_ms = parent_compare(dev, smi, parent, packed, w_tails, tijk, bf16_all, tm_demo)
        print(json.dumps({"parent": parent_ms}), flush=True)

    print(json.dumps({"c7_22x31x176": c7_table(dev, smi, "timing", fine=False)}), flush=True)
    say("timing", f"profiler traces so far: {TRACES['taken']} taken, {TRACES['lacking']} "
        f"without a kernel's records; launch records {TRACES['records']} of the "
        f"{TRACES['launches']} launches the traced calls made")
    lap("phase 6 (timing)")
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

    lap("phase 7 (rbf)")
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

    lap("phase 8 (svc fit)")
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

    lap("phase 9 (svc)")
    # -- 10. svc timing -----------------------------------------------------
    rbf_ms = {
        name: interleaved({
            "plain": lambda A=A, B_=B_: rbf.rbf_gram_ref(A, B_, cfg.gamma),
            "kernel": lambda A=A, B_=B_: rbf.rbf_gram(A, B_, cfg.gamma),
        }, inner=3, rounds=5)
        for name, (A, B_) in (("serving", (queries, S)), ("training", (X, X)))
    }
    # B6's traces are fenced as every trace is (utils/profiling.trace_device_us)
    # and counted: a call launches each of its three kernels once.
    traced = dict(TRACES)
    rbf_dev = {
        name: kernel_device_ms({"rbf": lambda A=A, B_=B_: rbf.rbf_gram(A, B_, cfg.gamma)},
                               RBF_SYMBOLS, reps=3, log=retrace,
                               launches=dict.fromkeys(RBF_SYMBOLS, 1))
        for name, (A, B_) in (("serving", (queries, S)), ("training", (X, X)))
    }
    rbf_records = {k: TRACES[k] - traced[k] for k in TRACES}
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

    say("svc timing", f"B6 profiler traces: {rbf_records['taken']} taken, "
        f"{rbf_records['lacking']} without a kernel's records; launch records "
        f"{rbf_records['records']} of the {rbf_records['launches']} launches the traced calls made")
    lap("phase 10 (svc timing)")
    # -- 11. apps ----------------------------------------------------------
    t0 = time.perf_counter()
    apps = phase_apps(dev, smi, g, gs, S.cpu().numpy(), fused, cubes, targets)
    say("apps", f"phase 11 in {time.perf_counter() - t0:.1f} s; gRPC {apps['grpc']}")

    lap("phase 11 (apps)")
    # -- 12. train -----------------------------------------------------------
    t0 = time.perf_counter()
    train = phase_train(dev, smi)
    say("train", f"phase 12 in {time.perf_counter() - t0:.1f} s")

    lap("phase 12 (train)")
    # -- 13. neural ----------------------------------------------------------
    t0 = time.perf_counter()
    neural = phase_neural(dev, smi)
    say("neural", f"phase 13 in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"neural": neural}), flush=True)
    lap("phase 13 (neural)")

    # -- 14. the serving artifact, capture and plots --------------------------
    export = phase_export(dev, smi, g, svc_pred)
    print(json.dumps({"export": export}), flush=True)
    lap("phase 14 (export)")

    # -- 15. multi-device: ranks in processes of their own -------------------
    mesh = phase_mesh(dev, smi, jax_svc)
    print(json.dumps({"mesh": mesh}), flush=True)
    lap("phase 15 (mesh)")

    # -- 16. the reference's sklearn pickles ----------------------------------
    ref = phase_reference(dev, smi)
    print(json.dumps({"reference": ref}), flush=True)
    lap("phase 16 (reference pickles)")

    # -- 17. the shapes past the table kernels' earlier limits -----------------
    shapes = phase_shapes(dev, smi)
    print(json.dumps({"shapes": shapes}), flush=True)
    lap("phase 17 (shapes)")

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
            "launches_export": export["launches_export"][name],
            "launches_mesh": mesh["launches_mesh"][name],
            "launches_reference": ref["launches"][name],
            "launches_shapes": shapes["launches"][name],
            "device_ms_shapes": {shape: res[name] for shape, res in shape_ms.items()},
        }

    records = [int8_record("onepass_tables_combined_i8", KERNEL_SOURCE, REPLACES,
                           launches, max_err)
               | {"ms_single": kernel_single["kernel"],
                  "plain_ms_single": kernel_single["plain"], "scans_per_s": rates,
                  "launches_predict_app": apps["b1_predict"],
                  "launches_serve_app": apps["b1_serve"],
                  "launches_export_serve": export["serve"]["b1"]}]
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
        "launches_export": export["launches_export"]["fused_native_score"],
        "launches_mesh": mesh["launches_mesh"]["fused_native_score"],
        "launches_reference": ref["launches"]["fused_native_score"],
        "launches_shapes": shapes["launches"]["fused_native_score"],
        "device_ms_shapes": {shape: res["native_tables"] for shape, res in shape_ms.items()},
        "fast_f32_ms_43x31x351": shape_ms["43x31x351"]["fast_f32"],
        "fast_f32_ms_9_classes": nine_ms,
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
        "launches_export": export["launches_export"]["rbf_gram"],
        "launches_mesh": mesh["launches_mesh"]["rbf_gram"],
        "launches_reference": ref["launches"]["rbf_gram"],
        "launches_shapes": shapes["launches"]["rbf_gram"],
    })
    say("profiler", f"{TRACES['taken']} traces taken for device times, {TRACES['lacking']} "
        f"of them without a kernel's records (each taken again); the traces that knew their "
        f"calls' launches held {TRACES['records']} launch records of {TRACES['launches']}")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(sys.argv[2:])
    else:
        main(sys.argv[1:])
