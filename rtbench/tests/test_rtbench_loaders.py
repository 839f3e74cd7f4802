"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic mix, limits and metric readers by name, and the
file keeps to the benchmark's format."""

import json
import re

import pytest

from rtbench import check, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "rtbench/run.py"]
    assert BENCH["paths"] == ["rtbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[section]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names), names
    for section in ("end_to_end", "per_layer"):
        for m in BENCH[section]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    w = spec.workload(BENCH, cell)
    config = spec.config(BENCH, w["config"])
    traffic = spec.traffic(w["traffic"])
    limits = spec.limits(cell)
    assert config["name"] == w["config"]
    kind = spec.kind(traffic["kind"])
    assert all(callable(getattr(kind, f)) for f in ("strata", "cameras", "warm_up", "loop"))
    assert set(limits) >= set(check.NUMBERS)
    for n in check.NUMBERS:
        assert 0.0 < limits[n]["limit"] < 1.0


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_its_layer_metrics_move(cell):
    e2e = {m["name"] for m in spec.metrics_of(BENCH, "end_to_end", cell)}
    layers = spec.metrics_of(BENCH, "per_layer", cell)
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.metric_reader(metric).read)


def test_configs_state_what_was_cut():
    for c in BENCH["configs"]:
        assert c["file"].startswith("rtbench/")
        config = spec.config(BENCH, c["name"])
        assert config["reduced"] == c["reduced"]
        assert config["source"] == c["source"]
        keys = {"triangles", "bounces", "assumed", "mesh", "floor", "camera", "lights", "materials", "compute"}
        assert keys <= set(config)
        # every key changed from the source says what stands in its place
        assert set(c["reduced"]) <= set(config["assumed"])


def test_end_to_end_readers_read_the_window():
    from rtbench.drive import Window

    w = Window(frames=40, wall_s=0.5, series={}, sampler=None, setup_s=9.5, accel_bytes=1234)
    read = {m["name"]: spec.metric_reader(m["name"]).read(w) for m in BENCH["end_to_end"]}
    assert read["frame_ms"] == pytest.approx(12.5) and read["frame_ms.384"] == read["frame_ms"]
    assert read["setup_s"] == 9.5 and read["accel_bytes"] == 1234.0
    assert spec.metric_reader("frame_ms").read(Window(0, 0.5, {}, None)) is None
