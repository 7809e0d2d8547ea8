"""What one run of the benchmark is: a cell of `BENCHMARK.json` resolved to
its files by name.

* the configuration: `BENCHMARK.json`'s `file` for it, a JSON object with
  the program's full `settings`, the `reference` module that computes it
  plainly (`benchmark/reference/<reference>.py`), its source and cuts;
* the traffic mix: `benchmark/traffic/<traffic>.json`, parameters only;
  its `driver` names the shared loop under `benchmark/harness/` that reads
  them;
* the per-layer metrics: `benchmark/metrics/<metric name>.py`, each a
  `read(record)` that returns a number or None;
* the limits of `correct`: `benchmark/limits/<cell name>.json`, one per
  number compared, and the precision of the cell's control ("fp8" or
  "int8", the reference one step below the configuration's bf16).

Adding a cell, a mix or a metric adds files and entries; no file here
changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float] = field(default_factory=dict)
    control: str = "fp8"

    @property
    def settings(self) -> dict:
        return self.config["settings"]

    def reference(self) -> ModuleType:
        return importlib.import_module(f"benchmark.reference.{self.config['reference']}")

    def driver(self) -> ModuleType:
        return importlib.import_module(f"benchmark.harness.{self.traffic['driver']}")


def load_manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of the manifest under `root`, its files read."""
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    limits_path = root / "benchmark" / "limits" / f"{name}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.is_file() else {}
    control = limits.pop("control", "fp8")
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
        traffic_name=w["traffic"], traffic=traffic,
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)],
        limits=limits, control=control)


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """`benchmark/metrics/<name>.py` as a module (the file name holds dots,
    so it is loaded by path)."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metrics(cell: Cell, record: dict, root: Path = ROOT) -> Dict[str, dict]:
    """Each per-layer metric of the cell whose reader finds something."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], root).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
