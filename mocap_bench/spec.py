"""Find a cell's parts by the names `BENCHMARK.json` gives them.

A cell (`workloads` entry) names a configuration and a traffic mix.  The
configuration's file is the one its `configs` entry names; the traffic mix
is `traffic/<traffic>.json`; the limits of the output check are
`limits/<workload>.json`; each per-layer metric is read by
`metrics/<metric>.py`, whose `read(trace)` returns a number or None.  A
later cell, configuration or metric is added with files and entries alone.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, List, NamedTuple, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Metric(NamedTuple):
    name: str
    unit: str
    moves: Optional[str]   # per-layer metrics: the end-to-end metric it moves


class Cell(NamedTuple):
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell `workload` with its configuration, traffic, limits and
    metrics; KeyError names what is missing."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(HERE / "limits" / f"{workload}.json") as f:
        limits = json.load(f)
    e2e = [Metric(m["name"], m["unit"], None)
           for m in bench["end_to_end"] if _applies(m, workload)]
    e2e_names = {m.name for m in e2e}
    per_layer = [Metric(m["name"], m["unit"], m["moves"])
                 for m in bench["per_layer"]
                 if m["moves"] in e2e_names and _applies(m, workload)]
    return Cell(name=workload, chips=int(w["chips"]), config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic, limits=limits,
                end_to_end=e2e, per_layer=per_layer)


def merged(cell: Cell, overrides: Optional[dict] = None):
    """The cell's pipeline, rig, traffic and scene dicts with `overrides`
    (the same four keys, for a rehearsal at a small size) merged in."""
    o = overrides or {}
    pipeline = {**cell.config["pipeline"], **o.get("pipeline", {})}
    rig = {**cell.config["rig"], **o.get("rig", {})}
    traffic = {**cell.traffic, **o.get("traffic", {})}
    return pipeline, rig, traffic, {**traffic["scene"], **o.get("scene", {})}


def reader(metric: str) -> Callable:
    """`metrics/<metric>.py`'s `read`, loaded from its file (the names
    carry dots, so they are not importable as modules)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"mocap_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

