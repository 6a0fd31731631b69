"""The benchmark's data, found by name: BENCHMARK.json at the checkout's
root, a configuration's file (configs/<name>.json), a traffic mix's file
(traffic/<name>.json), and each metric's file (metrics/<name>.json), which
names the reader (readers/<reader>.py) that takes the metric and the
reader's parameters.  A later cell, mix or metric is a new file here and
needs no code."""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # [(metric entry, its file)]
    per_layer: list


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _data(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def metric_file(name: str) -> dict:
    """A metric's file: {"reader": module under readers/, params...}."""
    return _data("metrics", name)


def reader(name: str):
    """The `read(ctx, **params)` function of readers/<name>.py."""
    return importlib.import_module(f"rhbench.readers.{name}").read


def _reports(metric: dict, cell: str, end_to_end=None) -> bool:
    """Whether `cell` reports `metric`: the cells its "workloads" key
    lists; without the key, every cell, and for a per-layer metric every
    cell that reports the end-to-end metric it moves (`end_to_end`: the
    names the cell reports)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return end_to_end is None or metric["moves"] in end_to_end


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration, traffic and
    the metrics it reports."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    return Cell(
        name=name, chips=int(entry["chips"]), config=config,
        traffic=_data("traffic", entry["traffic"]),
        end_to_end=[(m, metric_file(m["name"])) for m in e2e],
        per_layer=[(m, metric_file(m["name"])) for m in bench["per_layer"]
                   if _reports(m, name, names)],
    )
