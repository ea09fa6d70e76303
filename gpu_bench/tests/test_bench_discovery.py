"""Discovery by name, the refusal of unknown names, and BENCHMARK.json's shape."""

from __future__ import annotations

import json
import os
import re

import pytest

from gpu_bench import check, harness

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark(ROOT)


def test_every_cell_finds_its_files_by_name(bench):
    for cell in bench["workloads"]:
        cfg = harness.load_config(ROOT, bench, cell["config"])
        assert cfg["name"] == cell["config"]
        assert harness.load_traffic(cell["traffic"])["loop"] in ("frames", "train")
        assert check.load_limits(os.path.join(ROOT, "gpu_bench"), cell["name"])
    for m in bench["per_layer"]:
        reader = harness.load_metric(m["name"])
        assert reader.SOURCE == m["source"] and callable(reader.read)


@pytest.mark.parametrize("kind", ["cell", "config", "traffic", "metric"])
def test_unknown_names_are_refused(bench, kind):
    with pytest.raises(KeyError):
        {"cell": lambda: harness.find_cell(bench, "no_such.cell"),
         "config": lambda: harness.load_config(ROOT, bench, "no_such_config"),
         "traffic": lambda: harness.load_traffic("no_such_mix"),
         "metric": lambda: harness.load_metric("no_such_metric.fwd")}[kind]()


def test_cell_metrics_follow_the_workloads_lists(bench):
    names = lambda cell, kind: [m["name"] for m in harness.cell_metrics(bench, cell, kind)]  # noqa: E731
    assert names("pbr_scene.fwd", "end_to_end") == ["setup_s", "frame_rate", "frame_p95_ms"]
    assert names("pbr_scene.train", "end_to_end") == ["setup_s", "step_rate", "train_peak_mib"]
    assert "ibl_tail_ms.fwd" in names("rustediron_ibl.fwd", "per_layer")
    assert "ibl_tail_ms.fwd" not in names("pbr_scene.fwd", "per_layer")


def test_benchmark_json_keeps_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpu_bench"] and bench["command"][1] == "gpu_bench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {c["name"] for c in bench["workloads"]}
    assert "setup_s" in e2e
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("gpu_bench/") and c["reduced"] == []
        for text in (c["why"], c["source"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and cfg["assumed"]
    for c in bench["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"} and NAME.match(c["name"])
        assert c["chips"] == 1 and len(c["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"] and "\t" not in m["layer"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:  # every cell listed reports the metric it moves
            assert cell in next(e for e in bench["end_to_end"] if e["name"] == m["moves"]).get("workloads", [cell])
    for cell in cells:
        assert len(harness.cell_metrics(bench, cell, "end_to_end")) >= 2
        assert harness.cell_metrics(bench, cell, "per_layer")
