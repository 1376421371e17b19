"""BENCHMARK.json's shape (names, units, bounds, sizes), and the files it names
found by name."""
import json
import os
import re
import shutil

import pytest

from conftest import ROOT
from portbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.load_manifest()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def _names():
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[sec]:
            yield e["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    keys = {"name", "unit", "better", "source", "workloads"}
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= keys | {"bound"}
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert set(metric) <= keys | {"layer", "moves"}
        assert 1 <= len(metric["layer"]) <= 200


def test_unique_names():
    for sec in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[sec]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    c = manifest.cell(w["name"])
    assert c.chips == 1 == w["chips"]
    assert os.path.exists(os.path.join(
        ROOT, "portbench", "loops", c.traffic["loop"] + ".py"))
    assert set(c.limits) >= {"layout_faults"}
    assert len(w["why"]) <= 200
    for m in c.per_layer:
        assert callable(manifest.reader(m["name"]))
    assert "setup_s" in [e["name"] for e in c.end_to_end]
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(m):
    for name in m["workloads"]:
        e2e = [e["name"] for e in manifest.cell(name).end_to_end]
        assert m["moves"] in e2e, (m["name"], name)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert c["file"].startswith("portbench/configs/")
    assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    assert len(c["reduced"]) <= 16
    with open(os.path.join(ROOT, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    used = [w for w in BENCH["workloads"] if w["config"] == c["name"]]
    assert used


def test_a_cell_is_added_by_files_and_entries(tmp_path):
    """A new traffic mix, its limits and a workload entry make a new cell
    that the harness finds, with no edit to a file the benchmark has; a
    per-layer metric of its own is a reader file and an entry."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    traffic = json.load(open(root / "portbench/traffic/train.json"))
    traffic["interval_steps"] = 2000
    (root / "portbench/traffic/train2k.json").write_text(json.dumps(traffic))
    shutil.copy(root / "portbench/limits/hipct-divide-128x.train.json",
                root / "portbench/limits/hipct-divide-128x.train2k.json")
    bench["workloads"].append({
        "name": "hipct-divide-128x.train2k", "config": "hipct-divide-128x",
        "traffic": "train2k", "chips": 1, "why": "2,000-step intervals"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "hipct-divide-128x.train" in m.get("workloads", []):
            m["workloads"].append("hipct-divide-128x.train2k")
    (root / "portbench/metrics/steps_per_launch.py").write_text(
        "def read(r):\n    return 1.0 / r.launches_per_unit()\n")
    bench["per_layer"].append({
        "name": "steps_per_launch.train2k", "unit": "steps", "better":
        "higher", "source": "device_trace", "layer": "device", "moves":
        "train_coords_per_s", "workloads": ["hipct-divide-128x.train2k"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = manifest.cell("hipct-divide-128x.train2k", root=str(root))
    assert c.traffic["interval_steps"] == 2000
    assert {m["name"] for m in c.per_layer} == {
        "train_kernel_roofline", "train_mfu", "host_launches_per_step",
        "device_idle_share.train", "steps_per_launch.train2k"}
    for m in c.per_layer:
        assert callable(manifest.reader(m["name"], root=str(root)))


def test_reader_by_base_name():
    """A cell's variant of a metric is read by the quantity's own file."""
    def file(name):
        return os.path.basename(manifest.reader(name).__code__.co_filename)
    assert file("train_mfu.single") == file("train_mfu") == "train_mfu.py"
    assert file("device_idle_share.single") == \
        file("device_idle_share.train") == "device_idle_share.py"
