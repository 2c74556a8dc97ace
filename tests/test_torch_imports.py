"""The port's import rule: radarml_tpu_torch imports neither jax,
radarml_tpu nor sklearn, and importing it builds nothing.

Checked in a fresh interpreter where `import jax` fails outright: once
over every module of the package, once over the package, its two
serving apps and the serving artifact where grpc and protobuf are missing
too, as they may be where the card is (only rpc/ imports them; serve's
--grpc_port branch, fusion/ and the capture app import rpc/), once over
the train app and the metrics where matplotlib is missing (the card's
machine has none; only plot_confusion_matrix imports it), once over the
dnn and sgan apps where matplotlib is missing (only
utils/summary.plot_model_png imports it), once over viz/ and its two
apps (visualize, ground_truth_samples) where matplotlib is missing (they
import it only where they draw), and once over parallel/ and the two
timing utilities (slopetime, watchdog). No import starts a process group.

A scan of the sources pins which modules import grpc (rpc/ only) and
matplotlib (viz/, its two apps, train/metrics.py, utils/summary.py),
each of them where it uses it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
WITHOUT = %r
if WITHOUT == "grpc":
    sys.modules["grpc"] = None
    sys.modules["google.protobuf"] = None
if WITHOUT.startswith("matplotlib") or WITHOUT == "viz":
    sys.modules["matplotlib"] = None
import radarml_tpu_torch
if WITHOUT == "grpc":
    mods = ["radarml_tpu_torch.apps.predict", "radarml_tpu_torch.apps.serve",
            "radarml_tpu_torch.serving.export", "radarml_tpu_torch.ops.library"]
elif WITHOUT == "viz":
    mods = ["radarml_tpu_torch.viz", "radarml_tpu_torch.apps.visualize",
            "radarml_tpu_torch.apps.ground_truth_samples"]
elif WITHOUT == "matplotlib":
    mods = ["radarml_tpu_torch.apps.train", "radarml_tpu_torch.train"]
elif WITHOUT == "matplotlib_neural":
    mods = ["radarml_tpu_torch.apps.dnn", "radarml_tpu_torch.apps.sgan"]
elif WITHOUT == "parallel":
    mods = ["radarml_tpu_torch.parallel", "radarml_tpu_torch.parallel.spawn",
            "radarml_tpu_torch.utils.slopetime", "radarml_tpu_torch.utils.watchdog"]
else:
    mods = [m.name for m in pkgutil.walk_packages(radarml_tpu_torch.__path__,
                                                  "radarml_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
names = sorted(m for m in sys.modules if m.split(".")[0] == "radarml_tpu_torch")
leaked = sorted(
    m for m in sys.modules
    if m == "radarml_tpu" or m.startswith("radarml_tpu.")
    or m.split(".")[0] in ("jaxlib", "flax", "optax", "triton", "sklearn")
)
from radarml_tpu_torch.ops import _cuda_build
import torch.distributed as dist
print(json.dumps({"modules": names, "leaked": leaked,
                  "loaded": sorted(_cuda_build._loaded),
                  "group": dist.is_available() and dist.is_initialized()}))
"""


ALL_MODULES = (
    "radarml_tpu_torch.core.arena",
    "radarml_tpu_torch.ops.i8_score",
    "radarml_tpu_torch.ops.i8_tails",
    "radarml_tpu_torch.core.device",
    "radarml_tpu_torch.ops.rbf",
    "radarml_tpu_torch.models.svc",
    "radarml_tpu_torch.apps.common_cli",
    "radarml_tpu_torch.ops._cuda_build",
    "radarml_tpu_torch.models.pipeline",
    "radarml_tpu_torch.serving.stream",
    "radarml_tpu_torch.data.synthetic",
    "radarml_tpu_torch.utils.profiling",
    "radarml_tpu_torch.data.labels",
    "radarml_tpu_torch.drivers.native",
    "radarml_tpu_torch.serving.reload",
    "radarml_tpu_torch.rpc.radar_server",
    "radarml_tpu_torch.data.store",
    "radarml_tpu_torch.data.split",
    "radarml_tpu_torch.data.balance",
    "radarml_tpu_torch.ops.augment",
    "radarml_tpu_torch.models.linear",
    "radarml_tpu_torch.train.metrics",
    "radarml_tpu_torch.train.gridsearch",
    "radarml_tpu_torch.apps.train",
    "radarml_tpu_torch.data.preprocess",
    "radarml_tpu_torch.models.cnn",
    "radarml_tpu_torch.models.sgan",
    "radarml_tpu_torch.train.trainer",
    "radarml_tpu_torch.train.checkpoint",
    "radarml_tpu_torch.train.sgan_trainer",
    "radarml_tpu_torch.utils.summary",
    "radarml_tpu_torch.apps.dnn",
    "radarml_tpu_torch.apps.sgan",
    "radarml_tpu_torch.ops.library",
    "radarml_tpu_torch.serving.export",
    "radarml_tpu_torch.rpc.client",
    "radarml_tpu_torch.rpc.fake_server",
    "radarml_tpu_torch.rpc.detection_server_pb2",
    "radarml_tpu_torch.fusion.camera",
    "radarml_tpu_torch.fusion.capture",
    "radarml_tpu_torch.apps.ground_truth_samples",
    "radarml_tpu_torch.viz.plots",
    "radarml_tpu_torch.apps.visualize",
    "radarml_tpu_torch.parallel",
    "radarml_tpu_torch.parallel.mesh",
    "radarml_tpu_torch.parallel.train_step",
    "radarml_tpu_torch.parallel.spawn",
    "radarml_tpu_torch.utils.slopetime",
    "radarml_tpu_torch.utils.watchdog",
)
APPS = ("radarml_tpu_torch.apps.predict", "radarml_tpu_torch.apps.serve",
        "radarml_tpu_torch.apps.common_cli", "radarml_tpu_torch.drivers.native",
        "radarml_tpu_torch.serving.export", "radarml_tpu_torch.ops.library")
PARALLEL = ("radarml_tpu_torch.parallel", "radarml_tpu_torch.parallel.mesh",
            "radarml_tpu_torch.parallel.train_step", "radarml_tpu_torch.parallel.spawn",
            "radarml_tpu_torch.utils.slopetime", "radarml_tpu_torch.utils.watchdog")
VIZ = ("radarml_tpu_torch.viz.plots", "radarml_tpu_torch.apps.visualize",
       "radarml_tpu_torch.apps.ground_truth_samples", "radarml_tpu_torch.fusion.capture")


TRAIN = ("radarml_tpu_torch.apps.train", "radarml_tpu_torch.train.metrics",
         "radarml_tpu_torch.train.gridsearch", "radarml_tpu_torch.ops.augment")
NEURAL = ("radarml_tpu_torch.apps.dnn", "radarml_tpu_torch.apps.sgan",
          "radarml_tpu_torch.utils.summary", "radarml_tpu_torch.train.sgan_trainer",
          "radarml_tpu_torch.train.trainer", "radarml_tpu_torch.data.preprocess")


@pytest.mark.parametrize("without,expected",
                         [("", ALL_MODULES), ("grpc", APPS), ("matplotlib", TRAIN),
                          ("matplotlib_neural", NEURAL), ("viz", VIZ),
                          ("parallel", PARALLEL)],
                         ids=["all_modules", "apps_without_grpc", "train_without_matplotlib",
                              "neural_apps_without_matplotlib", "viz_without_matplotlib",
                              "parallel_and_timing_utils"])
def test_port_imports_without_jax_or_reference(without, expected):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", PROBE % without], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    assert res["loaded"] == []  # no kernel built at import
    assert res["group"] is False  # and no process group started
    for name in expected:
        assert name in res["modules"]
    if without == "grpc":
        assert not any(m.startswith("radarml_tpu_torch.rpc") for m in res["modules"])


IMPORTERS = {
    "grpc": {"rpc/__init__.py", "rpc/client.py", "rpc/fake_server.py", "rpc/radar_server.py"},
    "google.protobuf": {"rpc/detection_server_pb2.py", "rpc/radar_serving_pb2.py"},
    "matplotlib": {"viz/plots.py", "apps/visualize.py", "apps/ground_truth_samples.py",
                   "train/metrics.py", "utils/summary.py"},
}


@pytest.mark.parametrize("package", sorted(IMPORTERS))
def test_only_these_modules_import(package):
    """rpc/ is the only importer of grpc and protobuf; viz/ (with its two
    apps) and the two earlier plotting helpers the only importers of
    matplotlib."""
    import re

    root = REPO / "radarml_tpu_torch"
    pattern = re.compile(rf"^\s*(from|import)\s+{re.escape(package)}\b", re.M)
    found = {str(p.relative_to(root)) for p in root.rglob("*.py")
             if pattern.search(p.read_text())}
    if package == "grpc":  # rpc/__init__ imports grpc through its modules
        found.add("rpc/__init__.py")
    assert found == IMPORTERS[package]


@pytest.mark.parametrize("module", ["parallel/__init__.py", "parallel/mesh.py",
                                    "parallel/train_step.py", "parallel/spawn.py",
                                    "utils/slopetime.py", "utils/watchdog.py"])
def test_multi_device_modules_import_no_reference(module):
    """parallel/ and the timing utilities keep their own copies: no line
    of theirs imports jax, radarml_tpu or sklearn."""
    import re

    text = (REPO / "radarml_tpu_torch" / module).read_text()
    assert not re.search(r"^\s*(from|import)\s+(jax|jaxlib|radarml_tpu|sklearn)\b", text,
                         re.M)
