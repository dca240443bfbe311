"""A cell resolved by name: its entry in ``BENCHMARK.json``, its
configuration's file, its traffic mix's file, its limits' file and the
per-layer metrics that list it (or list no cells). Everything is found by
the names in ``BENCHMARK.json``, so a new configuration, mix or metric is
new files and entries."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Optional[Callable] = None  # per-layer metrics: the reader
    #: A reader of a kernel's time: the key its launches are counted under
    #: (``ops/launches.py``) and its names in the trace.
    launches: Optional[Tuple[str, Tuple[str, ...]]] = None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _reader(name: str, bench_dir: str):
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(entry: dict, cell: str, e2e_names) -> bool:
    """A metric goes to the cells it lists, else to every cell reporting
    the end-to-end metric it moves."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry["moves"] in e2e_names


def load(workload: str, root: str = ROOT,
         bench_dir: str = BENCH_DIR) -> Cell:
    """The cell named ``workload``; a ``KeyError`` names what is missing."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _read_json(os.path.join(bench_dir, "traffic",
                                      f"{w['traffic']}.json"))
    limits = _read_json(os.path.join(bench_dir, "limits",
                                     f"{workload}.json"))
    e2e = [Metric(m["name"], m["unit"]) for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m.name for m in e2e}
    per_layer = []
    for m in bench["per_layer"]:
        if _applies(m, workload, names):
            module = _reader(m["name"], bench_dir)
            per_layer.append(Metric(m["name"], m["unit"], module.read,
                                    getattr(module, "LAUNCHES", None)))
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e,
                per_layer)
