"""The port's import rule: radarml_tpu_torch imports neither jax,
radarml_tpu nor sklearn, and importing it builds nothing.

Checked in a fresh interpreter where `import jax` fails outright.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import radarml_tpu_torch
names = ["radarml_tpu_torch"]
for m in pkgutil.walk_packages(radarml_tpu_torch.__path__, "radarml_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
leaked = sorted(
    m for m in sys.modules
    if m == "radarml_tpu" or m.startswith("radarml_tpu.")
    or m.split(".")[0] in ("jaxlib", "flax", "optax", "triton", "sklearn")
)
from radarml_tpu_torch.ops import _cuda_build
print(json.dumps({"modules": names, "leaked": leaked,
                  "loaded": sorted(_cuda_build._loaded)}))
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    assert res["loaded"] == []  # no kernel built at import
    for name in (
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
    ):
        assert name in res["modules"]
