"""What ``BENCHMARK.json`` names, found as files by name.

A cell's configuration is the file its entry names; its traffic mix is
``traffic/<traffic>.json``; each metric is read by ``metrics/<name>.py``,
whose ``read(run)`` returns a number, or None where the run holds nothing
to read. Adding a configuration, a mix or a metric adds files and entries
and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

FOLDER = "benchmark"


def load(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(root: Path, bench: dict, name: str) -> dict:
    return json.loads((root / _named(bench["configs"], name, "config")["file"]).read_text())


def traffic(root: Path, name: str) -> dict:
    return json.loads((root / FOLDER / "traffic" / f"{name}.json").read_text())


def _in_cell(metric: dict, name: str) -> bool:
    return name in metric.get("workloads", [name])


def metrics(bench: dict, name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: each that lists the cell, or lists no cells, and moves an
    end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if _in_cell(m, name)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if _in_cell(m, name) and m["moves"] in moved]


def reader(root: Path, metric: str):
    """``read`` of ``metrics/<metric>.py``."""
    path = root / FOLDER / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def same_as(metric: str):
    """The reader of ``metric``, for a metric file that reads the same
    quantity under another name: in cells that report another end-to-end
    metric, or in another kind of traffic."""
    return reader(Path(__file__).resolve().parents[1], metric)
