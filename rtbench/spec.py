"""Where the benchmark finds what a cell names.

``BENCHMARK.json`` at the repository's root lists the cells; a cell
names a configuration (its ``file``, listed in ``configs``) and a
traffic mix (``rtbench/traffic/<traffic>.json``), whose ``kind`` is the
loop in ``rtbench/traffic/<kind>.py``; the comparison's limits of a
cell are ``rtbench/limits/<cell>.json``; a metric's reader, end-to-end
or per-layer, is ``rtbench/metrics/<metric>.py``.  A new cell,
configuration, mix, kind or metric is new files and entries: nothing
here changes.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return read_json(ROOT / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return read_json(HERE / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return read_json(HERE / "limits" / f"{cell}.json")


def metrics_of(bench: dict, section: str, cell: str) -> list[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``)
    that ``cell`` reports: those that list it, or list no cells."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


@functools.cache
def _module(folder: str, name: str):
    path = HERE / folder / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"rtbench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The module ``rtbench/metrics/<name>.py``: its ``read`` takes a
    :class:`rtbench.drive.Window` (an end-to-end metric) or a
    :class:`rtbench.trace.Trace` (a per-layer one) and returns the
    number, or None where there is nothing to read."""
    return _module("metrics", name)


def kind(name: str):
    """The module ``rtbench/traffic/<name>.py``: the loop of a traffic
    kind (``strata``, ``cameras``, ``warm_up``, ``loop``)."""
    return _module("traffic", name)
