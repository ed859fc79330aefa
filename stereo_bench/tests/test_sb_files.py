"""Every cell, configuration, traffic mix, metric and layer of
BENCHMARK.json resolves by name, and the file keeps to the benchmark's
rules on names, units, bounds and run length."""

import json
import re

import pytest

from soc_project_stereo_matching_tpu_torch import EngineConfig
from stereo_bench import check, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["stereo_bench"]
    assert (spec.CHECKOUT / BENCH["command"][1]).is_file()
    assert BENCH["command"][1].startswith("stereo_bench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    w = spec.workload(BENCH, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    config = spec.config(BENCH, w["config"])
    traffic = spec.traffic(w["traffic"])
    assert config["name"] == w["config"] and traffic["name"] == w["traffic"]
    feed = spec.feed(traffic["feed"])
    assert all(callable(getattr(feed, f)) for f in ("inputs", "call", "window"))
    assert traffic["keep"] >= 1 and traffic["pool"] >= 1
    e2e = {m["name"] for m in spec.metrics_of(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(BENCH, cell, True)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configuration_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("stereo_bench/configs/")
    config = spec.config(BENCH, entry["name"])
    assert config["reduced"] == entry["reduced"] == []
    assert config["options"]["max_disparity"] > config["options"]["min_disparity"]
    EngineConfig(**config["engine"])
    check.checkable(config)
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_has_a_reader_and_keeps_the_rules(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(spec.reader(metric["name"]))
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_bound(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_a_metric_its_cells_report(metric):
    assert "bound" not in metric
    for cell in metric["workloads"]:
        reported = {m["name"] for m in spec.metrics_of(BENCH, cell, False)}
        assert metric["moves"] in reported
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_names_are_unique_and_well_formed():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)


def test_every_layer_directory_has_patterns_and_a_metric():
    patterns = spec.layer_patterns()
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert patterns and all(patterns.values())
    for layer in patterns:
        assert layer in layers, f"layers/{layer} is read by no metric"
