"""The benchmark's data: BENCHMARK.json and the files it names.

A cell (one entry of `workloads`) is a configuration under a traffic
mix. Everything a cell is made of is found by name: the configuration's
file as BENCHMARK.json gives it, `traffic/<traffic>.json`, the limits of
its comparison in `limits/<workload>.json`, the code of its model family
in `families/<family>.py`, of its traffic's kind in `kinds/<kind>.py`,
and each metric's reader in `metrics/<metric>.py`. A later change adds a
cell, a mix or a metric as new files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict  # number compared -> its limit
    tie_margin: float
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path
    bench_dir: Path

    @property
    def family(self) -> ModuleType:
        return importlib.import_module(f"portbench.families.{self.config['family']}")

    @property
    def kind(self) -> ModuleType:
        return importlib.import_module(f"portbench.kinds.{self.traffic['kind']}")

    def config_file(self, key: str) -> Path:
        """A file named by the configuration, beside its own file."""
        return self.root / Path(self.config["file"]).parent / self.config[key]


def reader(name: str, bench_dir: Path = HERE) -> ModuleType:
    """The reader module of metric `name`: metrics/<name>.py."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _listed(metric: dict, workload: str) -> bool:
    """A metric without a `workloads` list is every cell's; where a cell's
    run finds nothing to read, its reader returns nothing."""
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str, bench_dir: Path = HERE) -> Cell:
    """The cell `workload` of root/BENCHMARK.json, with its files read."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = dict(json.loads((root / entry["file"]).read_text()), file=entry["file"])
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    check = json.loads((bench_dir / "limits" / f"{workload}.json").read_text())
    end_to_end = [m for m in bench["end_to_end"] if _listed(m, workload)]
    per_layer = [m for m in bench["per_layer"] if _listed(m, workload)]
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=check["limits"], tie_margin=float(check["tie_margin"]),
                end_to_end=end_to_end, per_layer=per_layer, root=root, bench_dir=bench_dir)
