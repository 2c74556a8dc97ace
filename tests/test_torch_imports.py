"""The port's import rule: radarml_tpu_torch imports neither jax,
radarml_tpu nor sklearn, and importing it builds nothing.

Checked in a fresh interpreter where `import jax` fails outright: once
over every module of the package, once over the package and its two
serving apps where grpc and protobuf are missing too, as they may be
where the card is (only rpc/ and serve's --grpc_port branch import them),
and once over the train app and the metrics where matplotlib is missing
(the card's machine has none; only plot_confusion_matrix imports it).
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
if WITHOUT == "matplotlib":
    sys.modules["matplotlib"] = None
import radarml_tpu_torch
if WITHOUT == "grpc":
    mods = ["radarml_tpu_torch.apps.predict", "radarml_tpu_torch.apps.serve"]
elif WITHOUT == "matplotlib":
    mods = ["radarml_tpu_torch.apps.train", "radarml_tpu_torch.train"]
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
print(json.dumps({"modules": names, "leaked": leaked,
                  "loaded": sorted(_cuda_build._loaded)}))
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
)
APPS = ("radarml_tpu_torch.apps.predict", "radarml_tpu_torch.apps.serve",
        "radarml_tpu_torch.apps.common_cli", "radarml_tpu_torch.drivers.native")


TRAIN = ("radarml_tpu_torch.apps.train", "radarml_tpu_torch.train.metrics",
         "radarml_tpu_torch.train.gridsearch", "radarml_tpu_torch.ops.augment")


@pytest.mark.parametrize("without,expected",
                         [("", ALL_MODULES), ("grpc", APPS), ("matplotlib", TRAIN)],
                         ids=["all_modules", "apps_without_grpc", "train_without_matplotlib"])
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
    for name in expected:
        assert name in res["modules"]
    if without == "grpc":
        assert not any(m.startswith("radarml_tpu_torch.rpc") for m in res["modules"])
