"""BENCHMARK.json and the files it names: a cell's configuration, its
traffic mix, its limits, and the per-layer metrics that read it.  Every
piece is found by its name, so a new cell, mix or metric is new files and
entries, and no edit."""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_manifest(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(root: str, *parts: str) -> Dict:
    with open(os.path.join(root, "portbench", *parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict          # configs/<config>.json
    traffic: Dict         # traffic/<traffic>.json
    limits: Dict          # limits/<cell>.json: check name -> limit
    end_to_end: List[Dict]
    per_layer: List[Dict]


def reports(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether a metric belongs to a cell: listed there, or, without a
    list, in every cell that reports the end-to-end metric it moves (an
    end-to-end metric without a list is in every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell of BENCHMARK.json (under root) named `name`, with its
    files."""
    m = load_manifest(root)
    found = [w for w in m["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = found[0]
    cfgs = {c["name"]: c for c in m["configs"]}
    cfg_file = cfgs[w["config"]]["file"]
    with open(os.path.join(root, cfg_file)) as f:
        config = json.load(f)
    e2e = [e for e in m["end_to_end"] if reports(e, name, [])]
    names = [e["name"] for e in e2e]
    per_layer = [p for p in m["per_layer"] if reports(p, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=_json(root, "traffic", w["traffic"] + ".json"),
                limits=_json(root, "limits", name + ".json"),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, root: str = ROOT) -> Callable:
    """metrics/<metric>.py's read(readings) -> float or None; a cell's
    variant of a quantity without a file of its own (train_mfu.single) is
    read by the quantity's file (metrics/train_mfu.py)."""
    path = os.path.join(root, "portbench", "metrics", metric + ".py")
    if not os.path.exists(path):
        path = os.path.join(root, "portbench", "metrics",
                            metric.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
