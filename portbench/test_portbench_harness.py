"""Tests of the benchmark itself, on the CPU at small batches (the card
tests carry the `cuda` marker). Run: python -m pytest portbench -q
"""

from __future__ import annotations

import ast
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import bounds, scenes, spec
from portbench.reference import zoom
from portbench.run import FORBIDDEN, ROOT, run_cell
from portbench.trace import from_ops

HERE = Path(__file__).resolve().parent
CELLS = ("sgd.fine_bulk", "svc.bulk", "sgd.bulk", "svc.fine_bulk")
SEED = 2**31 + 99


def small(workload: str, batch: int = 8, root: Path = ROOT, bench_dir: Path = HERE):
    """The cell with its traffic cut to `batch` scans a batch."""
    cell = spec.load_cell(root, workload, bench_dir)
    cell.traffic = dict(cell.traffic, batch=batch)
    return cell


def test_benchmark_json_is_consistent():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert [w["name"] for w in bench["workloads"]] == list(CELLS)
    for w in bench["workloads"]:
        cell = spec.load_cell(ROOT, w["name"])
        assert cell.chips == 1
        assert {m["name"] for m in cell.end_to_end} == {"scans_per_s", "setup_s"}
        for m in cell.per_layer:
            assert m["moves"] == "scans_per_s"
            spec.reader(m["name"])
        gap = "proba_gap" if cell.config["family"] == "linear" else "proba_gap_p999"
        assert set(cell.limits) == {gap, "wrong_answers"}
        assert cell.limits["wrong_answers"] == 0
        assert cell.tie_margin >= cell.limits[gap]


@pytest.mark.parametrize("workload", ["sgd.bulk", "svc.bulk"])
def test_seed_fixes_the_pool(workload):
    traffic = small(workload).traffic
    a = small(workload).kind.pool(traffic, SEED, "cpu")
    b = small(workload).kind.pool(traffic, SEED, "cpu")
    c = small(workload).kind.pool(traffic, SEED + 1, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x.cubes, y.cubes) and torch.equal(x.xyz, y.xyz)
        assert torch.equal(x.valid, y.valid) and x.voxels == y.voxels
    assert not torch.equal(a[0].cubes, c[0].cubes)
    assert not torch.equal(a[0].cubes, a[1].cubes)  # the pool's batches differ
    # every seed does the same work: each count of targets equally often
    for batch in a + c:
        counts = batch.valid.sum(1)
        assert sorted(counts.tolist()) == sorted((np.arange(8) % 4 + 1).tolist())


@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_runs_correct_on_the_cpu(workload):
    result = run_cell(small(workload), SEED, 2.0, False, "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"scans_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks" and result["failed"] == 0


def _altered_threshold(monkeypatch):
    """Break the program underneath: the first slot's answer of each batch
    altered where the predictor produces it."""
    from radarml_tpu_torch.models.pipeline import RadarPredictor

    original = RadarPredictor._threshold

    def threshold(self, proba, valid):
        pred, best, proba = original(self, proba, valid)
        pred, proba = pred.clone(), proba.clone()
        pred[0, 0] = (pred[0, 0] + 1) % proba.shape[-1]
        proba[0, 0] = proba[0, 0].roll(1)
        return pred, best, proba

    monkeypatch.setattr(RadarPredictor, "_threshold", threshold)


@pytest.mark.parametrize("workload", CELLS)
def test_an_altered_answer_is_not_correct(workload, monkeypatch):
    _altered_threshold(monkeypatch)
    result = run_cell(small(workload), SEED, 0.3, False, "cpu", time.perf_counter())
    assert result["correct"] is False
    assert result["checks"]["wrong_answers"]["value"] >= 1
    assert result["failed"] >= 1


@pytest.mark.parametrize("workload", ["sgd.bulk", "svc.bulk"])
def test_the_control_is_not_correct(workload):
    """The configuration's control (the next lower precision) in the
    program's place fails the cell's limits, at 64 scans a batch."""
    result = run_cell(small(workload, 64), SEED, 0.3, False, "cpu", time.perf_counter(),
                      role="control")
    assert result["correct"] is False
    gap = next(c for name, c in result["checks"].items() if name.startswith("proba_gap"))
    assert gap["value"] > gap["limit"]


def test_extend_by_new_files_only(tmp_path):
    """A configuration, a mix and a metric added as new files and entries
    make a runnable cell; no file that was there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bd = root / "portbench"
    cfg = json.loads((bd / "configs" / "sgd-linear-3c.json").read_text())
    cfg.update(name="sgd-linear-3c-lowthr", min_proba=0.5, weights="sgd-linear-3c-lowthr.npz")
    (bd / "configs" / "sgd-linear-3c-lowthr.json").write_text(json.dumps(cfg))
    shutil.copy(bd / "configs" / "sgd-linear-3c.npz", bd / "configs" / "sgd-linear-3c-lowthr.npz")
    mix = json.loads((bd / "traffic" / "bulk_16k.json").read_text())
    mix.update(batch=6, slots=3)
    (bd / "traffic" / "tiny_3slot.json").write_text(json.dumps(mix))
    (bd / "metrics" / "steps_per_s.py").write_text(
        "def read(run):\n    return len(run.window.counted()) / run.seconds\n")
    (bd / "limits" / "lowthr.tiny.json").write_text(
        json.dumps({"limits": {"proba_gap": 1e-4, "wrong_answers": 0}, "tie_margin": 1e-3}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sgd-linear-3c-lowthr", "source": "https://example.org",
                             "file": "portbench/configs/sgd-linear-3c-lowthr.json",
                             "reduced": ["min_proba"], "why": "test"})
    bench["workloads"].append({"name": "lowthr.tiny", "config": "sgd-linear-3c-lowthr",
                               "traffic": "tiny_3slot", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "steps_per_s", "unit": "steps/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["lowthr.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p
    cell = spec.load_cell(root, "lowthr.tiny", bd)
    assert cell.config["min_proba"] == 0.5 and cell.traffic["slots"] == 3
    result = run_cell(cell, SEED, 0.3, False, "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"scans_per_s", "setup_s", "steps_per_s"}
    assert result["metrics"]["steps_per_s"]["value"] > 0


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_nothing_loads_jax_and_the_reference_stands_alone():
    """Every module of the benchmark, and what a run of a cell loads,
    holds no module named jax, jaxlib, flax or radarml_tpu (whole
    top-level names); the reference imports nothing of the program."""
    for path in (HERE / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in ("torch", "numpy", "portbench", "__future__",
                                          "dataclasses", "functools", "typing"), (path, name)
            assert not name.startswith("portbench.") or name.startswith("portbench.reference"), \
                (path, name)
    code = (
        "import sys, time, importlib, pathlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import portbench.reference.linear, portbench.reference.svc\n"
        "assert not any(m.split('.')[0] == 'radarml_tpu_torch' for m in sys.modules)\n"
        "for p in pathlib.Path('portbench').rglob('*.py'):\n"
        "    if p.name.startswith(('test_', 'conftest')) or p.parent.name == 'metrics':\n"
        "        continue\n"
        "    importlib.import_module('.'.join(p.with_suffix('').parts))\n"
        "from portbench import spec\n"
        "from portbench.run import run_cell, forbidden_modules\n"
        "for w in ('sgd.bulk', 'svc.bulk'):\n"
        "    cell = spec.load_cell(pathlib.Path('.'), w)\n"
        "    cell.traffic = dict(cell.traffic, batch=4)\n"
        "    for m in cell.end_to_end + cell.per_layer:\n"
        "        spec.reader(m['name'])\n"
        "    assert run_cell(cell, 7, 0.2, False, 'cpu', time.perf_counter())['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top, forbidden = [eval(line) for line in out.stdout.strip().splitlines()[-2:]]
    assert forbidden == [] and not set(top) & set(FORBIDDEN)
    assert "radarml_tpu_torch" in top  # the program was loaded, and is told apart


def test_without_the_program_or_a_card_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, and
    on a host without a card, the command exits non-zero and prints no
    result line."""
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    args = ["--workload", "sgd.bulk", "--seed", str(SEED), "--seconds", "1", "--trace", "0"]
    alone = subprocess.run([sys.executable, "portbench/run.py", *args], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=300)
    assert alone.returncode != 0 and alone.stdout.strip() == ""
    if not torch.cuda.is_available():
        here = subprocess.run([sys.executable, "portbench/run.py", *args], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=300)
        assert here.returncode != 0 and here.stdout.strip() == ""


def test_bounds_at_the_cells_shapes():
    """Hand-worked least times: B1 over 4,096 scans of 43x31x351 (467,883
    B a cube) and 6 template rows; B6 over 65,536 rows x 1,823 vectors x
    10,010 features at 989 TFLOP/s; the steps' least work."""
    vox = 43 * 31 * 351
    assert vox == 467_883
    s, by = bounds.int8_tables(4096, (43, 31, 351), 6)
    nbytes = 4096 * 467_883 + 6 * (43 * 351 + 31 * 351 + 43 * 31) + 4 * 4096 * 6 * (43 + 31 + 351)
    assert by == "bytes" and math.isclose(s, nbytes / 3.35e12)
    assert math.isclose(s * 1e3, 0.58459, rel_tol=1e-4)
    s, by = bounds.int8_tables(16384, (22, 31, 176), 6)
    assert by == "bytes" and math.isclose(s * 1e3, 0.61397, rel_tol=1e-4)
    s, by = bounds.rbf_gram(65536, 1823, 10010)
    assert by == "operations" and math.isclose(s, 2 * 65536 * 1823 * 10010 / 989e12)
    assert math.isclose(s * 1e3, 2.4184, rel_tol=1e-4)
    # the Gram of a svc.bulk step's 40,960 valid targets (2.5 of 4 slots a scan)
    s, by = bounds.rbf_gram(40960, 1823, 10010)
    assert by == "operations" and math.isclose(s * 1e3, 1.5115, rel_tol=1e-4)
    # a zoom from 43x31x351 into 22x31x176: xz rows then columns, yz columns only, xy rows only
    zoom_ops = bounds.zoom_ops([(43, 351), (31, 351), (43, 31)], [(22, 176), (31, 176), (22, 31)])
    assert zoom_ops == (2 * 22 * 43 * 351 + 2 * 176 * 351 * 22) + 2 * 176 * 351 * 31 + 2 * 22 * 43 * 31
    assert bounds.zoom_ops([(22, 176)], [(22, 176)]) == 0
    # a step of sgd.fine_bulk: 10,240 valid targets, the voxels they cover
    s, by = bounds.linear_step(10240, 16384, 250_000_000, [(43, 351), (31, 351), (43, 31)],
                               [(22, 176), (31, 176), (22, 31)], 3, 10010)
    nbytes = 250_000_000 + 4 * 3 * 10013 + 16384 * 13 + 16384 * 16
    assert by == "bytes" and math.isclose(s, nbytes / 3.35e12)
    # a step of svc.bulk: 40,960 valid targets of 65,536 slots
    s, by = bounds.svc_step(40960, 65536, 380_000_000, [(22, 176), (31, 176), (22, 31)],
                            [(22, 176), (31, 176), (22, 31)], 3, 10010, 1823)
    ops = 40960 * (2 * 1823 * 10010 + 2 * 1823 * 3)
    assert by == "operations" and math.isclose(s, ops / 989e12)
    assert math.isclose(s * 1e3, 1.5115, rel_tol=1e-3)


def test_gram_roofline_counts_the_valid_targets():
    """B6's least work is one query row a valid target, not a row a slot:
    two svc.bulk steps of 40,960 valid targets each, over 2 x 1.5115 ms
    of B6's kernels, read 100%."""
    from types import SimpleNamespace as NS

    cell = spec.load_cell(ROOT, "svc.bulk")
    batch = NS(n_valid=40960, scans=16384)
    least_us = 1e6 * bounds.rbf_gram(40960, 1823, 10010)[0]
    kernels = [("rbf_gram_kernel", 0.0, 1.5 * least_us), ("rbf_pack_kernel", 0.0, 0.5 * least_us),
               ("gemm", 0.0, 5 * least_us)]
    run = NS(cell=cell, batches=[batch], window=NS(steps=[NS(batch=0), NS(batch=0)]),
             trace=NS(kernels=lambda: kernels))
    assert math.isclose(spec.reader("gram_roofline").read(run), 100.0)
    run.trace = NS(kernels=lambda: kernels[2:])
    assert spec.reader("gram_roofline").read(run) is None


def test_plane_voxels_counts_each_voxel_once():
    from portbench.reference.arena import Arena

    a = Arena()
    X, Y, Z = a.shape
    cells = torch.tensor([[[5, 6, 7], [5, 6, 7], [9, 10, 50]]])
    one = scenes.plane_voxels(cells, torch.tensor([[True, False, False]]), a)
    assert one == X * Z + Y * Z + X * Y - X - Y - Z + 1  # three planes through one cell
    same = scenes.plane_voxels(cells, torch.tensor([[True, True, False]]), a)
    assert same == one
    two = scenes.plane_voxels(cells, torch.tensor([[True, False, True]]), a)
    assert one < two < 2 * one


def test_reference_zoom_is_scipys():
    ndimage = pytest.importorskip("scipy.ndimage")
    rng = np.random.default_rng(3)
    for shape, out in (((43, 351), (22, 176)), ((31, 351), (31, 176)), ((43, 31), (22, 31))):
        plane = rng.uniform(0, 255, shape)
        ours = zoom.zoom_matrix(shape[0], out[0]) @ plane @ zoom.zoom_matrix(shape[1], out[1]).T
        theirs = ndimage.zoom(plane, (out[0] / shape[0], out[1] / shape[1]), order=3)
        assert theirs.shape == out
        np.testing.assert_allclose(ours, theirs, atol=1e-9)


def test_trace_window_busy_and_gaps():
    """The device window lies between the guard spins; busy time is the
    union of operations; a gap is labelled by the host's marked span."""
    ops = [("spin_kernel", 0.0, 100.0), ("a", 110.0, 150.0), ("b", 140.0, 160.0),
           ("Memcpy DtoH", 170.0, 175.0), ("c", 190.0, 200.0), ("spin_kernel", 220.0, 300.0),
           ("late", 310.0, 320.0)]
    marks = [(100.0, 111.0, "portbench.dispatch"), (160.0, 190.0, "portbench.wait")]
    host_ops = [(101.0, 109.0, "aten::copy_")]
    tr = from_ops(ops, marks, host_ops)
    assert (tr.start_us, tr.end_us) == (100.0, 220.0)
    assert tr.busy() == [(110.0, 160.0), (170.0, 175.0), (190.0, 200.0)]
    assert math.isclose(tr.busy_s(), 65e-6) and math.isclose(tr.window_s, 120e-6)
    assert [n for n, _, _ in tr.kernels()] == ["a", "b", "c"]
    assert tr.gaps() == [(100.0, 110.0), (160.0, 170.0), (175.0, 190.0), (200.0, 220.0)]
    assert tr.host_label(105.0) == "dispatch:aten::copy_"
    assert tr.host_label(165.0) == "wait"
    assert tr.host_label(210.0) == "other"
    idle = dict(tr.breakdown()["idle_gaps"])
    assert math.isclose(idle["wait"], 25e-6) and math.isclose(idle["dispatch"], 10e-6)
    with pytest.raises(RuntimeError):
        from_ops(ops[1:5])


@pytest.mark.cuda
def test_a_small_cell_on_the_card_traced(card):
    """A traced run on the card at 256 scans a batch: every per-layer
    metric its cell lists is read, shares below 100%."""
    for workload in ("sgd.fine_bulk", "svc.bulk"):
        cell = small(workload, 256)
        result = run_cell(cell, SEED, 1.0, True, card, time.perf_counter())
        assert result["correct"], result["checks"]
        assert set(result["metrics"]) == {m["name"] for m in cell.per_layer}
        for name, m in result["metrics"].items():
            if m["unit"] == "%":
                assert 0 < m["value"] < 100, (name, m)
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
