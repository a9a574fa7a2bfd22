"""A cell of BENCHMARK.json and what it names, found by name: the
configuration file, the traffic mix, the reference module, the inputs
module and the readers of the per-layer metrics."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    end_to_end: List[dict]  # the manifest's entries this cell reports
    per_layer: List[dict]


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest at ``root``."""
    m = manifest(root)
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in m["configs"] if c["name"] == entry["config"])
    with open(root / config["file"]) as f:
        cfg = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [x for x in m["end_to_end"] if _reports(x, name)]
    moved = {x["name"] for x in e2e}
    layer = [x for x in m["per_layer"]
             if _reports(x, name) and x["moves"] in moved]
    return Cell(name=name, chips=int(entry["chips"]), config=cfg,
                traffic=traffic, end_to_end=e2e, per_layer=layer)


def reference(cfg: dict):
    """The plain reference module a configuration names."""
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}")


def inputs(cfg: dict):
    """``make`` of the inputs module a configuration names
    (``benchmark/inputs/<inputs>.py``), or None where it names none."""
    if "inputs" not in cfg:
        return None
    return importlib.import_module(f"benchmark.inputs.{cfg['inputs']}").make


def reader(metric: str) -> Callable[[dict], object]:
    """``read(record)`` of metrics/<metric>.py: the metric's number from
    the traced run's record, or None where it finds nothing to read."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def readers(cell: Cell) -> Dict[str, Callable[[dict], object]]:
    return {m["name"]: reader(m["name"]) for m in cell.per_layer}
